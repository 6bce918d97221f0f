"""Chunk embedding, the port of ``VideoFeatureExtractor`` in
``mmer_tpu/preprocess/extract.py``.

The port starts from decoded arrays: file decoding, face detection, the
crop graph and ``SubchunkStream`` come with the serving slice.
"""

from __future__ import annotations

from typing import List, Optional

import numpy as np
import torch

from mmer_tpu_torch.config import ViViTConfig
from mmer_tpu_torch.models.layers import load_or_save_params
from mmer_tpu_torch.models.vivit import init_vivit


class VideoFeatureExtractor:
    """Batched ViViT chunk embedder on one device.

    ``params``: a state dict for the ViViT; else ``params_path`` (``.npz``)
    is loaded if it exists and written with the seeded weights if not; else
    the weights are seeded from ``cfg.param_seed``.
    """

    def __init__(self, cfg: Optional[ViViTConfig] = None, *,
                 device: torch.device | str, device_batch: int = 8,
                 params: Optional[dict] = None,
                 params_path: Optional[str] = None, use_kernels: bool = True):
        self.cfg = cfg or ViViTConfig()
        self.device = torch.device(device)
        self.device_batch = device_batch
        self.model = init_vivit(self.cfg, device=self.device,
                                use_kernels=use_kernels)
        load_or_save_params(self.model, params, params_path)

    @torch.inference_mode()
    def embed_chunks(self, chunks) -> np.ndarray:
        """(N, F, H, W, C) raw uint8 or float32 in [0, 1] → (N, dim) float32.

        Chunks go to the device in blocks of ``device_batch`` (the last
        block padded by repeating its final chunk, whose rows are dropped);
        uint8 frames are scaled by 1/255 on the device.
        """
        x_all = torch.as_tensor(chunks)
        n = x_all.shape[0]
        bs = self.device_batch
        out: List[np.ndarray] = []
        for start in range(0, n, bs):
            block = x_all[start:start + bs]
            if block.shape[0] < bs:
                block = torch.cat(
                    [block, block[-1:].expand(bs - block.shape[0],
                                              *block.shape[1:])])
            x = block.to(self.device)
            if x.dtype == torch.uint8:
                x = x.float() / 255.0
            out.append(self.model(x).cpu().numpy())
        return np.concatenate(out)[:n]
