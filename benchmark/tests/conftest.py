"""Shared pieces of the benchmark's tests: the repository's cells cut to tiny
widths, sizes and windows, which the CPU runs in seconds.

Run from the repository's root: ``python -m pytest benchmark/tests -q``
(``-o addopts=`` on a machine without JAX; the tests marked ``cuda`` skip
without a card).
"""

from __future__ import annotations

import copy
import time

import pytest
import torch

from benchmark import cell as cells, spec

TINY_VIVIT = dict(image_size=[32, 32], num_frames=8, dim=64, depth=2, heads=2,
                  dim_head=32, mlp_dim=256)
TINY_W2V2 = dict(hidden_dim=64, num_layers=2, num_heads=2, ffn_dim=256,
                 conv_dims=[32] * 7, num_conv_pos_embeddings=16,
                 num_conv_pos_embedding_groups=4, chunk_duration_s=1.0)
TINY_TRAFFIC = {
    "vivit-b.extract": dict(sizes=[5, 5], device_batch=4, trace_calls=2),
    # 1.0-1.2 s clips in 1 s pieces: the 1.02 s clip ends in a piece too
    # short for a frame, which embeds as zeros on both sides.
    "w2v2-large.extract": dict(clips_per_call=5, calls=2, seconds=[1.0, 1.2],
                               trace_calls=2),
    "w2v2-large.long": dict(clips_per_call=3, calls=2, seconds=[2.0, 3.5],
                            trace_calls=2),
}
CELLS = tuple(TINY_TRAFFIC)


def tiny_cell(name: str, dtype: str = "float32", limit: float = 1e-3,
              root=spec.ROOT) -> spec.Cell:
    """Cell ``name`` of the checkout at ``root`` at tiny widths in
    ``dtype``, with the check's limit ``limit``."""
    c = spec.cell(spec.load(root), name, root)
    c.config = copy.deepcopy(c.config)
    c.config["model"].update(TINY_VIVIT if c.config["kind"] == "vivit" else TINY_W2V2,
                             compute_dtype=dtype)
    c.traffic = dict(c.traffic, **TINY_TRAFFIC.get(name, {}),
                     limits={"worst_rel_l2": limit, "bias_rel_l2": limit})
    return c


def cpu_run(c: spec.Cell, traced: bool = False, hook=None, seed: int = 2**31 + 5):
    return cells.run(c, seed, 0.2, traced, torch.device("cpu"), time.perf_counter(),
                     hook=hook)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda", 0)
