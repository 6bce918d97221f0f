"""Seed-ensemble evaluation, the port of ``mmer_tpu/train/ensemble.py``:
average the softmax probabilities of N fusion models of one config (different
seeds or recipes) and score the blend.

The members run as one stacked forward (``train/fused.stacked_probs``);
ranking, blending and greedy selection are then host numpy.  Two selection
schemes: the validation-loss top-k rank (``ensemble_eval`` over a ranked
prefix) and greedy forward selection on the validation blend's macro-F1
(``greedy_select`` / ``greedy_ensemble_eval``, Caruana et al. 2004).
``soup_params`` is the uniform model soup, a negative control: independently
seeded runs are not linearly mode-connected.
"""

from __future__ import annotations

from typing import Dict, List, Sequence

import numpy as np
import torch

from mmer_tpu_torch.config import ModelConfig
from mmer_tpu_torch.models.fusion import MultimodalEmotionModel
from mmer_tpu_torch.train.fused import stacked_probs
from mmer_tpu_torch.train.metrics import (accuracy_from_confusion,
                                          prf_from_confusion)


def member_models(model_cfg: ModelConfig, params_list: Sequence[dict],
                  device: torch.device | str) -> List[MultimodalEmotionModel]:
    """State dicts → fusion models on ``device``, in evaluation mode."""
    members = []
    for state in params_list:
        model = MultimodalEmotionModel(model_cfg, device=device)
        model.load_state_dict({k: torch.as_tensor(v) for k, v in state.items()})
        members.append(model.eval())
    return members


def _split_rows(data, splits, split: str, device):
    idx = {"train": splits.train, "val": splits.val, "test": splits.test}[split]

    def dev(a):
        return torch.from_numpy(np.ascontiguousarray(a[idx])).to(device)

    return dev(data.video).float(), dev(data.audio).float(), dev(data.pad_mask)


def member_probs(model_cfg: ModelConfig, params_list: Sequence[dict],
                 data, splits, split: str,
                 device: torch.device | str = "cuda") -> np.ndarray:
    """Each member's softmax probabilities on one split, as a host
    ``(M, N, C)`` array, from one stacked forward."""
    video, audio, mask = _split_rows(data, splits, split, device)
    members = member_models(model_cfg, params_list, device)
    return stacked_probs(members, video, audio, mask).cpu().numpy()


def _macro_f1_np(labels: np.ndarray, preds: np.ndarray, n_cls: int) -> float:
    cm = np.zeros((n_cls, n_cls), np.int64)
    np.add.at(cm, (labels, preds), 1)
    return prf_from_confusion(cm)["macro_f1"]


def _confusion_np(labels: np.ndarray, preds: np.ndarray, n_cls: int) -> np.ndarray:
    cm = np.zeros((n_cls, n_cls), np.float32)
    np.add.at(cm, (labels, preds), 1.0)
    return cm


def greedy_select(val_probs: np.ndarray, val_labels: np.ndarray,
                  k_max: int, replace: bool = False) -> Dict:
    """Greedy forward ensemble selection on a selection split (test-blind
    when ``val_probs`` is the validation split).  Each step adds the member
    whose inclusion maximises the blend's macro-F1 (ties go to the lowest
    member index); ``replace=True`` may pick a member again.  Returns the
    pick order, the F1 path and the prefix at the path's maximum
    (``selected``)."""
    m, _, n_cls = val_probs.shape
    if m < 1 or k_max < 1:
        raise ValueError(f"need ≥1 member and k_max ≥ 1, got m={m}, "
                         f"k_max={k_max}")
    val_labels = np.asarray(val_labels)
    order: List[int] = []
    path: List[float] = []
    cur = np.zeros_like(val_probs[0])
    avail = set(range(m))
    for _ in range(min(k_max, m) if not replace else k_max):
        cands = sorted(avail) if not replace else range(m)
        best_i, best_f1 = -1, -1.0
        for i in cands:
            f1 = _macro_f1_np(
                val_labels, np.argmax(cur + val_probs[i], axis=1), n_cls)
            if f1 > best_f1:
                best_i, best_f1 = i, f1
        order.append(best_i)
        path.append(round(best_f1, 6))
        cur = cur + val_probs[best_i]
        if not replace:
            avail.remove(best_i)
    k_best = int(np.argmax(path)) + 1
    return {"order": order, "val_f1_path": path,
            "k_best": k_best, "selected": order[:k_best]}


def greedy_ensemble_eval(model_cfg: ModelConfig, params_list: Sequence[dict],
                         data, splits, k_max: int, replace: bool = False,
                         device: torch.device | str = "cuda") -> Dict:
    """Greedy-select members on the validation split, score the blend on
    test."""
    val_p = member_probs(model_cfg, params_list, data, splits, "val", device)
    test_p = member_probs(model_cfg, params_list, data, splits, "test", device)
    sel = greedy_select(val_p, data.labels[splits.val], k_max,
                        replace=replace)
    n_cls = val_p.shape[-1]
    blend = test_p[sel["selected"]].mean(axis=0)
    test_f1 = _macro_f1_np(np.asarray(data.labels[splits.test]),
                           np.argmax(blend, axis=1), n_cls)
    return {**sel, "test_macro_f1": round(float(test_f1), 6),
            "n_pool": len(params_list)}


def soup_params(params_list: Sequence[dict]) -> dict:
    """Uniform model soup (Wortsman et al. 2022): the element-wise mean of
    the members' state dicts."""
    if not params_list:
        raise ValueError("need at least one member to soup")
    return {k: torch.stack([torch.as_tensor(p[k]) for p in params_list]
                           ).mean(dim=0)
            for k in params_list[0]}


def ensemble_eval(model_cfg: ModelConfig, params_list: Sequence[dict],
                  data, splits, split: str = "test",
                  device: torch.device | str = "cuda") -> Dict[str, float]:
    """Mean-probability ensemble of the members ``params_list`` (state
    dicts) on one split, with each member's own macro-F1 for the uplift."""
    probs = member_probs(model_cfg, params_list, data, splits, split, device)
    idx = {"train": splits.train, "val": splits.val, "test": splits.test}[split]
    labels = np.asarray(data.labels[idx])
    n_cls = int(data.labels.max()) + 1
    members = []
    mean_probs = None
    for p in probs:
        cm = _confusion_np(labels, np.argmax(p, axis=1), n_cls)
        members.append({"macro_f1": prf_from_confusion(cm)["macro_f1"],
                        "accuracy": accuracy_from_confusion(cm)})
        mean_probs = p if mean_probs is None else mean_probs + p
    mean_probs = mean_probs / len(params_list)
    cm = _confusion_np(labels, np.argmax(mean_probs, axis=1), n_cls)
    stats = prf_from_confusion(cm)
    return {
        "n_members": len(params_list),
        "ensemble_macro_f1": stats["macro_f1"],
        "ensemble_accuracy": accuracy_from_confusion(cm),
        "member_macro_f1": [m["macro_f1"] for m in members],
        "member_mean_macro_f1": float(
            np.mean([m["macro_f1"] for m in members])),
    }
