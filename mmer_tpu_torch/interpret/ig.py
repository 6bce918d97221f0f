"""Integrated Gradients over (video, audio) inputs, the port of
``mmer_tpu/interpret/ig.py``.

Zeros baseline, target = predicted class by default, per-feature
attributions, |attr| summed over time for the video importances (reference
train2.py:776-864; serving variant back-end/app/libs/inference.py:268-352).
Every integration step folds into the batch: one forward of ``S·B`` rows and
one ``torch.autograd.grad`` of the summed target logits with respect to the
scaled inputs only, not a loop of ``S`` passes.  Quadrature: Gauss-Legendre
(Captum's default) or the right / middle Riemann rules.

The model behind ``logits_fn`` must be in evaluation mode (no dropout).
:func:`interpret_test_set` (the trainer's ``--interpret``) writes the
reference's artifacts: per-sample ``video_importances_{ts}.csv`` /
``audio_importances_{ts}.csv`` (``video_dim_i`` columns and ``label``) and
``global_importances_{ts}.json`` (``global_video`` / ``global_audio`` maps of
``dim_i``).
"""

from __future__ import annotations

import json
import os
from datetime import datetime
from typing import Callable, Optional, Tuple

import numpy as np
import torch


def _quadrature(n_steps: int, method: str) -> Tuple[np.ndarray, np.ndarray]:
    """→ (alphas in (0, 1], weights summing to 1)."""
    if method == "gausslegendre":
        nodes, weights = np.polynomial.legendre.leggauss(n_steps)
        return (nodes + 1.0) / 2.0, weights / 2.0
    if method == "riemann_right":
        return (np.arange(1, n_steps + 1) / n_steps,
                np.full(n_steps, 1.0 / n_steps))
    if method == "riemann_middle":
        return ((np.arange(n_steps) + 0.5) / n_steps,
                np.full(n_steps, 1.0 / n_steps))
    raise ValueError(f"unknown quadrature method {method}")


def integrated_gradients(logits_fn: Callable, video: torch.Tensor,
                         audio: torch.Tensor, mask: Optional[torch.Tensor],
                         targets: torch.Tensor, n_steps: int = 50,
                         method: str = "gausslegendre"
                         ) -> Tuple[torch.Tensor, torch.Tensor]:
    """IG attributions of ``logits_fn(video, audio, mask) -> (B, C)``
    logits at class ``targets`` (B,), with respect to a zeros baseline.
    video (B, T, Dv) and audio (B, Da) float32 → (attr_video, attr_audio)
    of the same shapes."""
    alphas_np, weights_np = _quadrature(n_steps, method)
    dev = video.device
    alphas = torch.as_tensor(alphas_np, dtype=torch.float32, device=dev)
    weights = torch.as_tensor(weights_np, dtype=torch.float32, device=dev)
    video = video.detach().float()
    audio = audio.detach().float()
    b = video.shape[0]
    v_flat = (alphas[:, None, None, None] * video[None]).reshape(
        (-1,) + video.shape[1:]).requires_grad_(True)      # (S·B, T, Dv)
    a_flat = (alphas[:, None, None] * audio[None]).reshape(
        (-1,) + audio.shape[1:]).requires_grad_(True)      # (S·B, Da)
    m_flat = None if mask is None else mask.repeat(n_steps, 1)
    t_flat = targets.to(device=dev, dtype=torch.long).repeat(n_steps)
    with torch.enable_grad():
        logits = logits_fn(v_flat, a_flat, m_flat).float()
        total = logits.gather(1, t_flat[:, None]).sum()
        gv, ga = torch.autograd.grad(total, (v_flat, a_flat))
    avg_v = torch.einsum("s,s...->...", weights,
                         gv.reshape((n_steps, b) + video.shape[1:]))
    avg_a = torch.einsum("s,s...->...", weights,
                         ga.reshape((n_steps, b) + audio.shape[1:]))
    return video * avg_v, audio * avg_a


def compute_attributions(logits_fn: Callable, video, audio, mask=None,
                         target=None, n_steps: int = 50,
                         method: str = "gausslegendre"):
    """Reference ``compute_attributions`` semantics (train2.py:776-840):
    ``target`` defaults to the predicted class."""
    video = torch.as_tensor(video, dtype=torch.float32)
    audio = torch.as_tensor(audio, dtype=torch.float32, device=video.device)
    mask = None if mask is None else torch.as_tensor(mask, device=video.device)
    if target is None:
        with torch.no_grad():
            target = torch.argmax(logits_fn(video, audio, mask), dim=-1)
    target = torch.as_tensor(target, device=video.device)
    return integrated_gradients(logits_fn, video, audio, mask, target,
                                n_steps, method)


def aggregate_importances(attr_video: torch.Tensor, attr_audio: torch.Tensor,
                          abs_sum: bool = True
                          ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Video: |attr| summed over time → (B, Dv); audio: |attr| → (B, Da)
    (train2.py:840-864)."""
    if abs_sum:
        attr_video, attr_audio = attr_video.abs(), attr_audio.abs()
    return attr_video.sum(dim=1), attr_audio


def interpret_test_set(logits_fn: Callable, data: dict, test_idx,
                       output_dir: str = "training_runs_2",
                       batch_size: int = 256, n_steps: int = 50,
                       top_k: int = 10, verbose: bool = True,
                       timestamp: Optional[str] = None,
                       device: torch.device | str = "cuda") -> dict:
    """Test-set importances with the reference's artifact schema
    (train2.py:866-935).  ``data`` holds host ``video`` / ``audio`` /
    ``pad_mask`` / ``labels`` arrays, ``test_idx`` indexes them; batches go
    to ``device``, where ``logits_fn``'s model lives."""
    os.makedirs(output_dir, exist_ok=True)
    ts = timestamp or datetime.now().strftime("%Y%m%d_%H%M%S")
    test_idx = np.asarray(test_idx)
    all_video, all_audio, all_mask, all_labels = (
        np.asarray(data[k]) for k in ("video", "audio", "pad_mask", "labels"))
    v_imp_all, a_imp_all, labels_all = [], [], []
    for start in range(0, len(test_idx), batch_size):
        idx = test_idx[start:start + batch_size]

        def dev(a):
            return torch.from_numpy(np.ascontiguousarray(a[idx])).to(device)

        av, aa = compute_attributions(logits_fn, dev(all_video), dev(all_audio),
                                      dev(all_mask), n_steps=n_steps)
        vi, ai = aggregate_importances(av, aa)
        v_imp_all.append(vi.detach().cpu().numpy())
        a_imp_all.append(ai.detach().cpu().numpy())
        labels_all.append(all_labels[idx])
    video_imp = np.concatenate(v_imp_all)
    audio_imp = np.concatenate(a_imp_all)
    labels = np.concatenate(labels_all)

    def write_csv(path, arr, prefix):
        cols = [f"{prefix}_dim_{i}" for i in range(arr.shape[1])] + ["label"]
        with open(path, "w") as f:
            f.write(",".join(cols) + "\n")
            for row, lab in zip(arr, labels):
                f.write(",".join(f"{v:.6g}" for v in row) + f",{int(lab)}\n")

    write_csv(os.path.join(output_dir, f"video_importances_{ts}.csv"),
              video_imp, "video")
    write_csv(os.path.join(output_dir, f"audio_importances_{ts}.csv"),
              audio_imp, "audio")
    gv = video_imp.mean(axis=0)
    ga = audio_imp.mean(axis=0)
    if verbose:
        for name, g in (("Video", gv), ("Audio", ga)):
            print(f"Global Top-{top_k} {name} Feature Importances:")
            for i in np.argsort(-g)[:top_k]:
                print(f"  Dim {i}: {g[i]:.4f}")
    global_results = {
        "global_video": {f"dim_{i}": float(gv[i]) for i in range(len(gv))},
        "global_audio": {f"dim_{i}": float(ga[i]) for i in range(len(ga))},
    }
    json_path = os.path.join(output_dir, f"global_importances_{ts}.json")
    with open(json_path, "w") as f:
        json.dump(global_results, f, indent=4)
    if verbose:
        print(f"Global importances saved to {json_path}")
    return global_results
