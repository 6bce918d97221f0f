"""Checkpointing: best/final model artifacts and full-state resume, the port
of ``mmer_tpu/train/checkpoint.py``.

- flax ``.msgpack`` params trees (the JAX package's checkpoints, and the
  flagship's) are read and written by :func:`load_params_msgpack` /
  :func:`save_params_msgpack` through the port's own msgpack codec
  (``core/msgpack.py``); ``models/convert.py`` maps the fusion tree to a state
  dict and back;
- best/final weights are saved as ``.pth`` state dicts of
  :class:`~mmer_tpu_torch.models.fusion.MultimodalEmotionModel` (a batchnorm
  model's running statistics are buffers of the state dict) under the
  reference's naming scheme (``best_model_bs{b}_ep{e}_lr{lr}_{ts}.pth``,
  train2.py:766-774); ``InferenceEngine(fusion_params_path=...)`` loads them;
- the full training state (model, optimizer, best weights, and the key
  schedule's ``rng`` words and ``step``, JAX's ``TrainState.rng`` and
  ``step``) is checkpointed as ``state_{epoch:06d}.pth`` beside the
  host loop's scalars (lr, plateau counters, early-stop streak, best
  tracking) in ``loop_{epoch:06d}.json``, so that a resumed run continues the
  interrupted one exactly; a checkpoint of the older layout (torch
  generator states) is refused.

Everything is loaded with ``torch.load(weights_only=True)``.
"""

from __future__ import annotations

import json
import os
from typing import Any, Dict, NamedTuple, Optional

import numpy as np
import torch

from mmer_tpu_torch.core import msgpack


def save_params_msgpack(path: str, params: Any) -> None:
    """A params tree (nested dicts of numpy arrays or tensors) → the bytes
    ``flax.serialization.to_bytes`` writes for it, keys in the tree's
    order."""
    def host(tree):
        if isinstance(tree, dict):
            return {str(k): host(v) for k, v in tree.items()}
        if isinstance(tree, torch.Tensor):
            return tree.detach().cpu().numpy()
        return np.asarray(tree)

    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    with open(path, "wb") as f:
        f.write(msgpack.packb(host(params)))


def load_params_msgpack(path: str) -> Dict[str, Any]:
    """A flax ``.msgpack`` checkpoint → its tree of numpy arrays (what
    ``flax.serialization.msgpack_restore`` returns for it)."""
    with open(path, "rb") as f:
        tree = msgpack.unpackb(f.read())
    if not isinstance(tree, dict):
        raise ValueError(f"{path}: not a flax params tree")
    return tree


def load_fusion_checkpoint(path: str, model_cfg, device: torch.device | str):
    """A fusion checkpoint → a ``MultimodalEmotionModel`` of ``model_cfg``
    on ``device``, in evaluation mode.  Reads the port's ``.pth`` state
    dicts, the reference's v2 ``.pth`` (``models/port_fusion``) and flax
    ``.msgpack`` params trees (the JAX trainer's, the flagship's).  Loud on
    every failure: a missing file, another format, a tree that is not a
    fusion model's, a shape that disagrees with ``model_cfg``."""
    from mmer_tpu_torch.models.convert import fusion_from_flax
    from mmer_tpu_torch.models.fusion import MultimodalEmotionModel
    from mmer_tpu_torch.models.port_fusion import (is_reference_state_dict,
                                                   params_from_state_dict,
                                                   read_state_dict)

    if not os.path.exists(path):
        raise FileNotFoundError(f"fusion checkpoint not found: {path}")
    if path.endswith(".msgpack"):
        try:
            sd = fusion_from_flax(load_params_msgpack(path))
        except (KeyError, TypeError) as e:
            raise ValueError(f"{path}: not a fusion params tree "
                             f"(missing {e})") from e
    elif path.endswith(".pth"):
        sd = read_state_dict(path)
        if is_reference_state_dict(sd):
            # Reference-trained checkpoint (train2.py:766-774): converted,
            # its shapes validated against model_cfg.
            sd, _ = params_from_state_dict(sd, model_cfg)
    else:
        raise ValueError(f"{path}: the port reads .pth and flax .msgpack "
                         "fusion checkpoints")
    model = MultimodalEmotionModel(model_cfg, device=device)
    try:
        model.load_state_dict({k: torch.as_tensor(v) for k, v in sd.items()})
    except RuntimeError as e:
        raise ValueError(f"{path} does not fit the fusion config "
                         f"{model_cfg}: {e}") from e
    return model.eval()


def save_state_dict(path: str, state: Dict[str, torch.Tensor]) -> None:
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    torch.save({k: v.detach().cpu() for k, v in state.items()}, path)


def load_state_dict(path: str, device: torch.device | str = "cpu"
                    ) -> Dict[str, torch.Tensor]:
    return torch.load(path, map_location=device, weights_only=True)


def save_norm_stats(data, output_dir: str, stem: str) -> Optional[str]:
    """Persist the training-time global z-score statistics next to the model
    artifacts, so that serving normalises features the way training did (the
    reference trains on z-scored features and serves raw ones)."""
    if data.video_mean is None:
        return None
    path = os.path.join(output_dir, f"norm_stats_{stem}.npz")
    np.savez(path, video_mean=data.video_mean, video_std=data.video_std,
             audio_mean=data.audio_mean, audio_std=data.audio_std)
    return path


def latest_checkpoint(ckpt_dir: str) -> Optional[str]:
    if not os.path.isdir(ckpt_dir):
        return None
    entries = sorted(e for e in os.listdir(ckpt_dir)
                     if e.startswith("state_") and e.endswith(".pth"))
    return os.path.join(ckpt_dir, entries[-1]) if entries else None


class RestoredLoop(NamedTuple):
    payload: Dict[str, Any]   # what save_loop_checkpoint was given
    loop: dict                # scheduler / early-stop / best-tracking scalars
    step: int                 # the epoch the checkpoint was taken after


def save_loop_checkpoint(ckpt_dir: str, step: int, payload: Dict[str, Any],
                         loop: dict) -> str:
    """Write ``state_{step:06d}.pth`` (the payload: tensors, state dicts,
    the key schedule's ``rng`` words and ``step`` under ``"keys"``) and
    ``loop_{step:06d}.json`` (the loop scalars)."""
    os.makedirs(ckpt_dir, exist_ok=True)
    path = os.path.join(ckpt_dir, f"state_{step:06d}.pth")
    tmp = path + ".tmp"
    torch.save(payload, tmp)
    os.replace(tmp, path)
    with open(os.path.join(ckpt_dir, f"loop_{step:06d}.json"), "w") as f:
        json.dump(loop, f)
    return path


def restore_loop_checkpoint(path: str, device: torch.device | str = "cpu"
                            ) -> RestoredLoop:
    step = os.path.basename(path).split(".")[0].split("_")[1]
    loop_path = os.path.join(os.path.dirname(path), f"loop_{step}.json")
    if not os.path.exists(loop_path):
        raise FileNotFoundError(f"{path}: its loop file {loop_path} is missing")
    payload = torch.load(path, map_location=device, weights_only=True)
    if "keys" not in payload:
        raise ValueError(
            f"{path}: an older checkpoint layout, with torch generator states "
            "('shuffle_rng', 'dropout_rng'); the trainer now draws JAX's keys "
            "and resumes from JAX's TrainState.rng and step ('keys'), so this "
            "run cannot be continued: start it again")
    with open(loop_path) as f:
        loop = json.load(f)
    loop["sched_bad"] = int(loop["sched_bad"])
    loop["best_epoch"] = int(loop["best_epoch"])
    loop["no_improve"] = int(loop["no_improve"])
    loop["has_best"] = bool(loop["has_best"])
    return RestoredLoop(payload, loop, int(step))
