"""Viola-Jones Haar-cascade face detection without OpenCV, the port of
``mmer_tpu/preprocess/cascade.py``.

The JAX package's detector needs ``cv2`` for ``cv2.resize(INTER_AREA)`` at
every pyramid level and finds the cascade XML through OpenCV's install.
The machine with the GPU has no ``cv2``, so this copy:

- resamples with :func:`_resize_area`, numpy area resampling equal to
  ``cv2.resize(..., interpolation=cv2.INTER_AREA)`` on float64 images
  (``tests/test_torch_media.py`` holds it to cv2 within 1e-9 at every
  pyramid size of the serving frames);
- ships the cascade in the package (``assets/``, gzipped; OpenCV's license
  header is inside the file) and reads it with the stdlib;
- builds its own copy of the C++ evaluator (``csrc/cascade_eval.cpp``) with
  ``g++`` at first use (``ops/_build.host_library``).

Semantics follow OpenCV's evaluation rules for stump-based HAAR cascades:
raw sums over the 1-px-inset normalisation rect, ``vnf = sqrt(area·Σx² −
(Σx)²)``, stump test ``feat < thresh · vnf``, stage sum against the stage
threshold, neighbour-count grouping.  The native evaluator and the numpy
engine run the same order of operations.  The numpy engine is the fallback
when the library does not build: :attr:`HaarCascade.engine` says which one
runs, so a caller can refuse the fallback.
"""

from __future__ import annotations

import functools
import gzip
import math
import os
import xml.etree.ElementTree as ET
from dataclasses import dataclass
from typing import List, Optional, Tuple

import numpy as np

ASSETS = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                      "assets")


def find_cascade_file(name: str = "haarcascade_frontalface_default.xml"
                      ) -> Optional[str]:
    """The packaged (gzipped) copy of OpenCV's cascade ``name``, or None."""
    path = os.path.join(ASSETS, name + ".gz")
    return path if os.path.exists(path) else None


def read_cascade_xml(path: str) -> bytes:
    """The XML bytes of a cascade file, plain or gzipped (``.gz``)."""
    opener = gzip.open if path.endswith(".gz") else open
    with opener(path, "rb") as f:
        return f.read()


def _area_fast(img: np.ndarray, dh: int, dw: int, sy: int, sx: int
               ) -> np.ndarray:
    """cv2's integer-ratio INTER_AREA: block sums times float32(1/area)."""
    blocks = img[:dh * sy, :dw * sx].reshape(dh, sy, dw, sx)
    return blocks.sum(axis=(1, 3)) * float(np.float32(1.0 / (sy * sx)))


@functools.lru_cache(maxsize=256)
def _area_matrix(ssize: int, dsize: int):
    """(dsize, ssize) CSR matrix of cv2's ``computeResizeAreaTab``: exact
    area overlaps over the cell width, each weight rounded to float32 as cv2
    stores it.  A row's taps ascend in source index, the order in which cv2
    accumulates them."""
    from scipy.sparse import csr_matrix

    scale = ssize / dsize
    indptr, indices, weights = [0], [], []
    for dx in range(dsize):
        fsx1 = dx * scale
        fsx2 = fsx1 + scale
        cell = min(scale, ssize - fsx1)
        sx1, sx2 = math.ceil(fsx1), math.floor(fsx2)
        sx2 = min(sx2, ssize - 1)
        sx1 = min(sx1, sx2)
        if sx1 - fsx1 > 1e-3:
            indices.append(sx1 - 1)
            weights.append((sx1 - fsx1) / cell)
        for sx in range(sx1, sx2):
            indices.append(sx)
            weights.append(1.0 / cell)
        if fsx2 - sx2 > 1e-3:
            indices.append(sx2)
            weights.append(min(min(fsx2 - sx2, 1.0), cell) / cell)
        indptr.append(len(indices))
    data = np.asarray(weights, np.float32).astype(np.float64)
    return csr_matrix((data, np.asarray(indices), np.asarray(indptr)),
                      shape=(dsize, ssize))


def _resize_area(img: np.ndarray, size: Tuple[int, int]) -> np.ndarray:
    """``cv2.resize(img, size, interpolation=cv2.INTER_AREA)`` for a 2-D
    float64 image shrunk to ``size = (width, height)``, in numpy.

    Separable, as cv2 runs it: each row is resampled over x, then the rows
    are combined over y (``W_y · (W_x · imgᵀ)ᵀ``) with cv2's area-overlap
    weights, or block averages when both ratios are integers (cv2's fast
    path)."""
    dw, dh = size
    h, w = img.shape
    img = np.asarray(img, np.float64)
    if dw > w or dh > h:
        raise ValueError("_resize_area shrinks only (cv2 interpolates "
                         "linearly when INTER_AREA enlarges)")
    sx, sy = w / dw, h / dh
    eps = np.finfo(np.float64).eps
    if abs(sx - round(sx)) < eps and abs(sy - round(sy)) < eps:
        return _area_fast(img, dh, dw, int(round(sy)), int(round(sx)))
    rows = (_area_matrix(w, dw) @ img.T).T               # (h, dw)
    return np.ascontiguousarray(_area_matrix(h, dh) @ rows)   # (dh, dw)


@dataclass
class _Stage:
    threshold: float
    # stump arrays, one row per weak classifier
    feature_idx: np.ndarray    # (W,) int32
    node_thresh: np.ndarray    # (W,) float32
    left_val: np.ndarray       # (W,) float32
    right_val: np.ndarray      # (W,) float32


_NATIVE_CTX_CACHE: dict = {}     # xml path -> (lib, ctx) | "failed"


class HaarCascade:
    """Parsed stump-based cascade + multi-scale detector: the C++ evaluator
    when it builds, else the numpy engine; :attr:`engine` says which."""

    def __init__(self, xml_path: str):
        self._xml_path = os.path.abspath(xml_path)
        root = ET.fromstring(read_cascade_xml(xml_path))
        cascade = root.find("cascade")
        if cascade is None:
            raise ValueError(f"{xml_path}: not a new-format cascade file")
        if (cascade.findtext("featureType") or "").strip() != "HAAR":
            raise ValueError("only HAAR cascades are supported")
        self.win_w = int(cascade.findtext("width"))
        self.win_h = int(cascade.findtext("height"))

        # Features: up to 3 weighted rects each → dense (F, 3, 5) array of
        # (x, y, w, h, weight); unused slots have weight 0.
        feats = []
        for feat in cascade.find("features"):
            rects = []
            for r in feat.find("rects"):
                vals = r.text.split()
                rects.append([int(vals[0]), int(vals[1]), int(vals[2]),
                              int(vals[3]), float(vals[4])])
            if feat.findtext("tilted", "0").strip() == "1":
                raise ValueError("tilted features are not supported")
            while len(rects) < 3:
                rects.append([0, 0, 0, 0, 0.0])
            feats.append(rects[:3])
        self.features = np.asarray(feats, np.float32)        # (F, 3, 5)

        self.stages: List[_Stage] = []
        for stage in cascade.find("stages"):
            f_idx, n_thr, l_val, r_val = [], [], [], []
            for weak in stage.find("weakClassifiers"):
                nodes = weak.findtext("internalNodes").split()
                leaves = weak.findtext("leafValues").split()
                # stump: [left_child, right_child, featureIdx, threshold]
                if len(nodes) != 4:
                    raise ValueError("only stump-based cascades supported")
                f_idx.append(int(nodes[2]))
                n_thr.append(float(nodes[3]))
                l_val.append(float(leaves[0]))
                r_val.append(float(leaves[1]))
            self.stages.append(_Stage(
                threshold=float(stage.findtext("stageThreshold")),
                feature_idx=np.asarray(f_idx, np.int32),
                node_thresh=np.asarray(n_thr, np.float32),
                left_val=np.asarray(l_val, np.float32),
                right_val=np.asarray(r_val, np.float32)))

    @property
    def engine(self) -> str:
        """``"native"`` or ``"numpy"``: the engine :meth:`detect` runs
        (building the native library on first access)."""
        return "native" if self._native() is not None else "numpy"

    # ------------------------------------------------------------------
    def _native(self):
        """(lib, ctx) for the C++ evaluator, or None when it does not build.
        Contexts are cached per cascade file, module-wide."""
        cached = _NATIVE_CTX_CACHE.get(self._xml_path)
        if cached is None:
            try:
                cached = self._build_native()
            except (OSError, RuntimeError):
                cached = "failed"
            _NATIVE_CTX_CACHE[self._xml_path] = cached
        return None if cached == "failed" else cached

    def _build_native(self):
        import ctypes

        from mmer_tpu_torch.ops._build import host_library

        lib = host_library("cascade_eval")
        lib.cascade_create.restype = ctypes.c_void_p
        lib.cascade_detect_scaled.restype = ctypes.c_int
        c_dbl = ctypes.POINTER(ctypes.c_double)
        c_int = ctypes.POINTER(ctypes.c_int32)

        stage_off = np.cumsum(
            [0] + [len(s.feature_idx) for s in self.stages]).astype(np.int32)
        stage_thr = np.asarray([s.threshold for s in self.stages], np.float64)
        feat_idx = np.concatenate(
            [s.feature_idx for s in self.stages]).astype(np.int32)
        node_thr = np.concatenate(
            [s.node_thresh for s in self.stages]).astype(np.float64)
        left = np.concatenate(
            [s.left_val for s in self.stages]).astype(np.float64)
        right = np.concatenate(
            [s.right_val for s in self.stages]).astype(np.float64)
        features = np.ascontiguousarray(self.features, np.float64)
        ctx = lib.cascade_create(
            self.win_w, self.win_h, len(self.stages),
            stage_off.ctypes.data_as(c_int), stage_thr.ctypes.data_as(c_dbl),
            feat_idx.ctypes.data_as(c_int), node_thr.ctypes.data_as(c_dbl),
            left.ctypes.data_as(c_dbl), right.ctypes.data_as(c_dbl),
            len(feat_idx), features.shape[0], features.ctypes.data_as(c_dbl))
        if not ctx:
            raise RuntimeError("cascade_create returned NULL")
        return lib, ctypes.c_void_p(ctx)

    def _detect_single_scale(self, sat: np.ndarray, sat2: np.ndarray,
                             stride: int) -> np.ndarray:
        """All surviving window origins at one scale, for a batch of frames.

        sat/sat2: (F, H+1, W+1) integral images of the scaled gray frames.
        Returns (N, 3) array of (frame, x, y) origins in scaled coordinates.
        """
        n_frames = sat.shape[0]
        h = sat.shape[1] - 1 - self.win_h
        w = sat.shape[2] - 1 - self.win_w
        if h <= 0 or w <= 0:
            return np.zeros((0, 3), np.int64)
        ys0, xs0 = np.mgrid[0:h:stride, 0:w:stride]
        per_frame = ys0.size
        xs = np.tile(xs0.ravel(), n_frames)
        ys = np.tile(ys0.ravel(), n_frames)
        fs = np.repeat(np.arange(n_frames), per_frame)

        def window_sum(img, f, x0, y0, ww, hh):
            return (img[f, y0 + hh, x0 + ww] - img[f, y0, x0 + ww]
                    - img[f, y0 + hh, x0] + img[f, y0, x0])

        # OpenCV's normalisation: raw sums over the 1-px-inset normrect,
        # vnf = sqrt(area·Σx² − (Σx)²), stump test on raw feature sums.
        norm_area = (self.win_w - 2) * (self.win_h - 2)
        total = window_sum(sat, fs, xs + 1, ys + 1, self.win_w - 2,
                           self.win_h - 2)
        sq = window_sum(sat2, fs, xs + 1, ys + 1, self.win_w - 2,
                        self.win_h - 2)
        nf = norm_area * sq - total * total
        vnorm = np.where(nf > 0, np.sqrt(np.maximum(nf, 0.0)), 1.0)

        alive = np.ones(len(xs), dtype=bool)
        for stage in self.stages:
            ax, ay, af, av = xs[alive], ys[alive], fs[alive], vnorm[alive]
            n_alive = len(ax)
            if n_alive == 0:
                return np.zeros((0, 3), np.int64)
            rects = self.features[stage.feature_idx]      # (W, 3, 5)
            n_weak = rects.shape[0]
            rx = rects[:, :, 0].astype(np.int64)
            ry = rects[:, :, 1].astype(np.int64)
            rw = rects[:, :, 2].astype(np.int64)
            rh = rects[:, :, 3].astype(np.int64)
            rweight = rects[:, :, 4].astype(np.float64)

            # All stumps of the stage at once, chunked over windows so the
            # (chunk, W, 3) gather stays bounded.
            stage_sum = np.empty(n_alive, np.float64)
            chunk = max(1, int(4e6 // max(n_weak * 3, 1)))
            for s in range(0, n_alive, chunk):
                cx = ax[s:s + chunk, None, None]
                cy = ay[s:s + chunk, None, None]
                cf = af[s:s + chunk, None, None]
                x0, y0 = cx + rx[None], cy + ry[None]
                sums = (sat[cf, y0 + rh[None], x0 + rw[None]]
                        - sat[cf, y0, x0 + rw[None]]
                        - sat[cf, y0 + rh[None], x0] + sat[cf, y0, x0])
                feat = np.einsum("nwr,wr->nw", sums, rweight)
                passed = feat < (stage.node_thresh[None, :]
                                 * av[s:s + chunk, None])
                stage_sum[s:s + chunk] = np.where(
                    passed, stage.left_val[None, :],
                    stage.right_val[None, :]).sum(axis=1)
            alive[np.flatnonzero(alive)[stage_sum < stage.threshold]] = False
        return np.stack([fs[alive], xs[alive], ys[alive]], axis=1)

    def _pyramid(self, h: int, w: int, scale_factor: float,
                 min_size: int):
        """Yield ``(scale, sw, sh)`` per pyramid level: one owner of the
        scale seed, bound and rounding rules for both engines."""
        scale = max(min_size / self.win_w, 1.0)
        while self.win_w * scale <= min(h, w):
            yield scale, int(round(w / scale)), int(round(h / scale))
            scale *= scale_factor

    def detect_many(self, grays: List[np.ndarray],
                    scale_factor: float = 1.2, min_neighbors: int = 3,
                    stride: int = 2, min_size: int = 48
                    ) -> List[List[Tuple[float, float, float, float, float]]]:
        """The numpy engine over same-shaped gray frames: :meth:`detect`'s
        fallback when the native evaluator does not build."""
        n = len(grays)
        if n == 0:
            return []
        h, w = grays[0].shape
        raw: List[List[Tuple[int, int, int]]] = [[] for _ in range(n)]

        for scale, sw, sh in self._pyramid(h, w, scale_factor, min_size):
            scaled = np.stack([
                _resize_area(np.ascontiguousarray(g, np.float64), (sw, sh))
                for g in grays])
            sat = np.zeros((n, sh + 1, sw + 1))
            sat2 = np.zeros((n, sh + 1, sw + 1))
            np.cumsum(np.cumsum(scaled, 1), 2, out=sat[:, 1:, 1:])
            np.cumsum(np.cumsum(scaled * scaled, 1), 2,
                      out=sat2[:, 1:, 1:])
            for f, x, y in self._detect_single_scale(sat, sat2, stride):
                raw[f].append((int(round(x * scale)), int(round(y * scale)),
                               int(round(self.win_w * scale))))

        return [_group_rectangles(r, min_neighbors) for r in raw]

    def detect(self, gray: np.ndarray, scale_factor: float = 1.2,
               min_neighbors: int = 3, stride: int = 2,
               min_size: int = 48) -> List[Tuple[float, float, float, float, float]]:
        """→ [(x1, y1, x2, y2, conf)], conf from the neighbour count, on
        the engine :attr:`engine` names."""
        native = self._native()
        if native is None:
            return self.detect_many([gray], scale_factor, min_neighbors,
                                    stride, min_size)[0]
        import ctypes

        lib, ctx = native
        h, w = gray.shape
        raw: List[Tuple[int, int, int]] = []
        cap = ((h // stride) + 2) * ((w // stride) + 2)
        out = np.empty(2 * cap, np.int32)
        out_ptr = out.ctypes.data_as(ctypes.POINTER(ctypes.c_int32))
        gray64 = np.ascontiguousarray(gray, np.float64)
        for scale, sw, sh in self._pyramid(h, w, scale_factor, min_size):
            scaled = np.ascontiguousarray(_resize_area(gray64, (sw, sh)))
            n = lib.cascade_detect_scaled(
                ctx, scaled.ctypes.data_as(ctypes.POINTER(ctypes.c_double)),
                sh, sw, stride, out_ptr, cap)
            for i in range(n):
                raw.append((int(round(out[2 * i] * scale)),
                            int(round(out[2 * i + 1] * scale)),
                            int(round(self.win_w * scale))))
        return _group_rectangles(raw, min_neighbors)


def _group_rectangles(raw: List[Tuple[int, int, int]], min_neighbors: int,
                      eps: float = 0.2
                      ) -> List[Tuple[float, float, float, float, float]]:
    """Cluster near-identical detections; keep clusters with enough
    neighbours (cv2.groupRectangles semantics: connected components of the
    pairwise similarity relation, from
    ``scipy.sparse.csgraph.connected_components``)."""
    n = len(raw)
    if n == 0:
        return []
    arr = np.asarray(raw, np.float64)
    x, y, s = arr[:, 0], arr[:, 1], arr[:, 2]

    from scipy.sparse import coo_matrix
    from scipy.sparse.csgraph import connected_components

    rows: List[np.ndarray] = []
    cols: List[np.ndarray] = []
    block = 2048                      # ≤ n·2048 bools live at once
    for lo in range(0, n, block):
        hi = min(lo + block, n)
        delta = eps * np.minimum(s[lo:hi, None], s[None, :])
        adj = ((np.abs(x[lo:hi, None] - x[None, :]) <= delta)
               & (np.abs(y[lo:hi, None] - y[None, :]) <= delta)
               & (np.abs(s[lo:hi, None] - s[None, :]) <= 2 * delta))
        r, c = np.nonzero(adj)
        rows.append(r + lo)
        cols.append(c)
    graph = coo_matrix(
        (np.ones(sum(len(r) for r in rows), np.int8),
         (np.concatenate(rows), np.concatenate(cols))), shape=(n, n))
    n_comp, labels = connected_components(graph, directed=False)

    out = []
    order = np.argsort(labels, kind="stable")
    bounds = np.searchsorted(labels[order], np.arange(n_comp + 1))
    for c in range(n_comp):
        members = order[bounds[c]:bounds[c + 1]]
        if len(members) < max(min_neighbors, 1):
            continue
        m = arr[members].mean(axis=0)
        conf = 1.0 - 1.0 / (1.0 + len(members))
        out.append((float(m[0]), float(m[1]),
                    float(m[0] + m[2]), float(m[1] + m[2]), conf))
    out.sort(key=lambda r: -r[4])
    return out
