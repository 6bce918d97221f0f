"""ctypes binding of the bulk ``.npy`` loader, the port of
``mmer_tpu/data/native_loader.py``.

``csrc/npy_loader.cpp`` (a byte-for-byte copy of ``native/npy_loader.cpp``)
reads the small feature artifacts with ``pread``, a minimal header parser
and a ``std::thread`` pool, writing rows straight into caller-provided
buffers.  It is built with ``g++`` at first use into ``build/kernels/``
(``ops/_build.host_library``).

Unlike the JAX binding, nothing here degrades quietly: a missing compiler, a
failed build or a library of the wrong version raises.  Callers that want
the numpy route ask for it (``use_native=False``).  A file that breaks the
artifact contract is not a failure of the loader: it is reported (rows −1,
a failure count), and :func:`load_feature_arrays_native` returns None so
that the caller re-reads the batch through numpy for its per-file errors.
"""

from __future__ import annotations

import ctypes
from typing import List, Optional, Sequence, Tuple

import numpy as np

VERSION = 1


def library() -> ctypes.CDLL:
    """The loaded loader library, built at first use; raises on failure."""
    from mmer_tpu_torch.ops._build import host_library

    lib = host_library("npy_loader")
    lib.mmer_native_version.restype = ctypes.c_int
    version = lib.mmer_native_version()
    if version != VERSION:
        raise RuntimeError(f"npy_loader library version {version}, expected "
                           f"{VERSION}")
    lib.mmer_load_f32_batch.argtypes = [
        ctypes.POINTER(ctypes.c_char_p), ctypes.c_int, ctypes.c_long,
        ctypes.c_long, ctypes.POINTER(ctypes.c_float),
        ctypes.POINTER(ctypes.c_int), ctypes.c_int]
    lib.mmer_load_f32_batch.restype = ctypes.c_int
    lib.mmer_load_f16_vec_batch.argtypes = [
        ctypes.POINTER(ctypes.c_char_p), ctypes.c_int, ctypes.c_long,
        ctypes.POINTER(ctypes.c_float), ctypes.c_int]
    lib.mmer_load_f16_vec_batch.restype = ctypes.c_int
    return lib


def _path_array(paths: Sequence[str]):
    arr = (ctypes.c_char_p * len(paths))()
    arr[:] = [p.encode() for p in paths]
    return arr


def load_f32_batch(paths: Sequence[str], cols: int, max_rows: int,
                   n_threads: int = 16) -> Tuple[np.ndarray, np.ndarray]:
    """→ (out (N, max_rows, cols) float32 zero-padded, rows (N,) int32).

    ``rows[i]`` is the file's true row count (more than ``max_rows`` for an
    oversized artifact, whose first ``max_rows`` rows are read), or −1 for a
    file that is missing or breaks the contract."""
    lib = library()
    n = len(paths)
    out = np.zeros((n, max_rows, cols), np.float32)
    rows = np.zeros(n, np.int32)
    names = _path_array(paths)
    lib.mmer_load_f32_batch(
        names, n, cols, max_rows,
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
        rows.ctypes.data_as(ctypes.POINTER(ctypes.c_int)), n_threads)
    return out, rows


def load_f16_vec_batch(paths: Sequence[str], length: int,
                       n_threads: int = 16) -> Tuple[np.ndarray, int]:
    """→ ((N, length) float32, the number of files that failed)."""
    lib = library()
    n = len(paths)
    out = np.zeros((n, length), np.float32)
    names = _path_array(paths)
    failures = lib.mmer_load_f16_vec_batch(
        names, n, length, out.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
        n_threads)
    return out, int(failures)


def load_feature_arrays_native(video_paths: Sequence[str],
                               audio_paths: Sequence[str],
                               video_dim: int = 768, audio_dim: int = 1024,
                               max_rows: int = 64, n_threads: int = 16
                               ) -> Optional[Tuple[List[np.ndarray], np.ndarray]]:
    """The native route of ``data/pipeline.load_feature_arrays``: (per-clip
    (T, video_dim) float32 arrays, (N, audio_dim) float32), or None when a
    file breaks the contract (the numpy route then names it).  An artifact
    of more than ``max_rows`` rows is re-read with ``np.load``."""
    video_padded, rows = load_f32_batch(video_paths, video_dim, max_rows,
                                        n_threads)
    if (rows < 0).any():
        return None
    audios, failures = load_f16_vec_batch(audio_paths, audio_dim, n_threads)
    if failures:
        return None
    videos: List[np.ndarray] = []
    for i, path in enumerate(video_paths):
        if rows[i] > max_rows:
            videos.append(np.load(path).astype(np.float32))
        else:
            videos.append(video_padded[i, :rows[i]])
    return videos, audios
