"""The three ``cv2`` image operations the face tracker needs, in numpy.

The JAX package's tracker (``mmer_tpu/preprocess/faces.py``) rotates a grey
region of interest to retry a tilted face and matches a face template by
normalised cross-correlation, both through ``cv2``.  The GPU machine has no
``cv2``, so the port computes them itself:

- :func:`rotation_matrix_2d` and :func:`invert_affine`: the arithmetic of
  ``cv2.getRotationMatrix2D`` and ``cv2.invertAffineTransform``, in float64
  as OpenCV does it (the centre rounded to float32, as OpenCV's ``Point2f``
  holds it).
- :func:`warp_affine`: ``cv2.warpAffine(gray, m, (w, h),
  borderMode=cv2.BORDER_REPLICATE)`` on uint8, bilinear.  OpenCV 5.0 runs
  it in float32 (``warpAffineLinearInvoker_8UC1``): the matrix is inverted in
  float64 and rounded to float32; each row's offset ``y·M1 + M2`` is rounded
  twice; a source coordinate is one fused multiply-add off it, and the
  bilinear blend three more (across x on both rows, then across y); the
  value is rounded half to even and saturated.  On an AVX2 host the kernel
  takes 16 pixels a step and computes the tail of a row, past the last full
  step, as ``fma(x, M0, y·M1) + M2``.  Each tap's index is clamped to the
  image (the replicated border).  A fused multiply-add is emulated in
  float64 (the float32 product is exact there) and rounded once to float32.
  ``tests/test_torch_prep.py`` holds it bit-equal to cv2.
- :class:`TemplateMatcher` (:func:`match_template_ccoeff_normed`,
  :func:`match_template_best`): ``cv2.matchTemplate(image, templ,
  cv2.TM_CCOEFF_NORMED)`` and ``cv2.minMaxLoc``'s maximum, after OpenCV's
  normalisation rules (``templmatch.cpp``), in float64: the
  cross-correlation is the exact integer sum of the uint8 products (a
  float64 FFT's result, whose error is far below 0.5 at these sizes,
  rounded), the window sums come from integral images, and the score is
  rounded to float32 at the end, as OpenCV stores it.  OpenCV computes the
  correlation in float32, so the scores agree closely (within 1e-5 on the
  face templates of ``tests/test_torch_prep.py``; less closely on a nearly
  flat template), not bit for bit.
"""

from __future__ import annotations

import math
from typing import Tuple

import numpy as np

_F32 = np.float32
# OpenCV 5.0's linear warp kernel on an AVX2 host: two vectors of 8 lanes.
_WARP_STEP = 16


def rotation_matrix_2d(center: Tuple[float, float], angle: float,
                       scale: float) -> np.ndarray:
    """(2, 3) float64 ``cv2.getRotationMatrix2D(center, angle, scale)``:
    a rotation by ``angle`` degrees (counter-clockwise) about ``center``."""
    cx, cy = (float(_F32(c)) for c in center)
    rad = angle * (math.pi / 180)
    alpha = math.cos(rad) * scale
    beta = math.sin(rad) * scale
    return np.array([[alpha, beta, (1 - alpha) * cx - beta * cy],
                     [-beta, alpha, beta * cx + (1 - alpha) * cy]], np.float64)


def invert_affine(m: np.ndarray) -> np.ndarray:
    """(2, 3) float64 ``cv2.invertAffineTransform(m)``."""
    m = np.asarray(m, np.float64).reshape(6)
    d = m[0] * m[4] - m[1] * m[3]
    d = 1.0 / d if d != 0 else 0.0
    a11, a22 = m[4] * d, m[0] * d
    a12, a21 = -m[1] * d, -m[3] * d
    b1 = -a11 * m[2] - a12 * m[5]
    b2 = -a21 * m[2] - a22 * m[5]
    return np.array([[a11, a12, b1], [a21, a22, b2]], np.float64)


def _fma(a, b, c) -> np.ndarray:
    """float32 ``a·b + c`` rounded once."""
    return (np.asarray(a, np.float64) * np.asarray(b, np.float64)
            + np.asarray(c, np.float64)).astype(_F32)


def warp_affine(gray: np.ndarray, m: np.ndarray, dsize: Tuple[int, int]
                ) -> np.ndarray:
    """``cv2.warpAffine(gray, m, dsize, borderMode=cv2.BORDER_REPLICATE)``
    for a 2-D uint8 image, bilinear: output pixel (x, y) samples ``gray``
    at ``invert_affine(m) @ (x, y, 1)``.  ``dsize = (width, height)``."""
    if gray.ndim != 2 or gray.dtype != np.uint8:
        raise ValueError("warp_affine takes a 2-D uint8 image")
    w, h = dsize
    mi = invert_affine(m).reshape(6).astype(_F32)
    xs = np.arange(w, dtype=_F32)[None, :]
    ys = np.arange(h, dtype=_F32)[:, None]
    row_x = ys * mi[1] + mi[2]           # float32, rounded twice
    row_y = ys * mi[4] + mi[5]
    sx = _fma(mi[0], xs, row_x)
    sy = _fma(mi[3], xs, row_y)
    tail = (w // _WARP_STEP) * _WARP_STEP
    if tail < w:
        xt = xs[:, tail:]
        sx[:, tail:] = _fma(xt, mi[0], ys * mi[1]) + mi[2]
        sy[:, tail:] = _fma(xt, mi[3], ys * mi[4]) + mi[5]
    ix = np.floor(sx)
    iy = np.floor(sy)
    ax, ay = sx - ix, sy - iy             # exact in float32
    ix, iy = ix.astype(np.int64), iy.astype(np.int64)
    rows, cols = gray.shape
    x0, x1 = np.clip(ix, 0, cols - 1), np.clip(ix + 1, 0, cols - 1)
    y0, y1 = np.clip(iy, 0, rows - 1), np.clip(iy + 1, 0, rows - 1)
    g = gray.astype(_F32)
    p00, p01 = g[y0, x0], g[y0, x1]
    p10, p11 = g[y1, x0], g[y1, x1]
    top = _fma(ax, p01 - p00, p00)
    bottom = _fma(ax, p11 - p10, p10)
    v = _fma(ay, bottom - top, top)
    return np.clip(np.rint(v), 0, 255).astype(np.uint8)


def _box_sums(integral: np.ndarray, th: int, tw: int) -> np.ndarray:
    """Sums over every (th, tw) window from a zero-padded integral image,
    in OpenCV's order ``p0 - p1 - p2 + p3``."""
    return (integral[th:, tw:] - integral[:-th, tw:]
            - integral[th:, :-tw] + integral[:-th, :-tw])


def _integral(a: np.ndarray) -> np.ndarray:
    out = np.zeros((a.shape[0] + 1, a.shape[1] + 1), np.float64)
    out[1:, 1:] = a.cumsum(0).cumsum(1)
    return out


class TemplateMatcher:
    """``cv2.matchTemplate(image, templ, cv2.TM_CCOEFF_NORMED)`` of one
    uint8 image against several templates: the image's spectrum and integral
    images are computed once."""

    def __init__(self, image: np.ndarray):
        if image.ndim != 2:
            raise ValueError("match_template takes 2-D images")
        self.shape = image.shape
        img = image.astype(np.float64)
        self._spectrum = np.fft.rfft2(img)
        self._sum = _integral(img)
        self._sq = _integral(img * img)

    def _cross_correlation(self, templ: np.ndarray) -> np.ndarray:
        """Exact ``Σ image[i+u, j+v]·templ[u, v]`` at every valid (i, j):
        a float64 FFT's error on these integer sums is far below 0.5, so
        rounding its result gives them exactly."""
        h, w = self.shape
        th, tw = templ.shape
        ft = np.fft.rfft2(templ.astype(np.float64), s=(h, w))
        corr = np.fft.irfft2(self._spectrum * np.conj(ft), s=(h, w))
        return np.rint(corr[:h - th + 1, :w - tw + 1])

    def scores(self, templ: np.ndarray) -> np.ndarray:
        """The (H - th + 1, W - tw + 1) float32 map of the mean-subtracted
        normalised correlation at each placement of ``templ``."""
        if templ.ndim != 2:
            raise ValueError("match_template takes 2-D images")
        th, tw = templ.shape
        h, w = self.shape
        if th > h or tw > w:
            raise ValueError("the template is larger than the image")
        area = th * tw
        inv_area = 1.0 / area
        t = templ.astype(np.float64)
        # cv2.meanStdDev: the mean, and the variance as E[t²] - mean².
        t_mean = t.sum() / area
        t_var = max((t * t).sum() / area - t_mean * t_mean, 0.0)
        if t_var < np.finfo(np.float64).eps:
            return np.ones((h - th + 1, w - tw + 1), _F32)
        t_norm = math.sqrt(t_var) / math.sqrt(inv_area)
        win_sum = _box_sums(self._sum, th, tw)
        win_sq = _box_sums(self._sq, th, tw)
        num = self._cross_correlation(templ) - win_sum * t_mean
        diff2 = np.maximum(win_sq - win_sum * win_sum * inv_area, 0.0)
        flat = diff2 <= np.minimum(0.5, 10 * np.finfo(np.float32).eps * win_sq)
        den = np.where(flat, 0.0, np.sqrt(diff2) * t_norm)
        mag = np.abs(num)
        with np.errstate(divide="ignore", invalid="ignore"):
            score = np.where(mag < den, num / den,
                             np.where(mag < den * 1.125, np.sign(num), 0.0))
        return score.astype(_F32)

    def best(self, templ: np.ndarray) -> Tuple[float, Tuple[int, int]]:
        """(score, (x, y)) of the best placement of ``templ``: the maximum
        of :meth:`scores`, its first occurrence in row-major order, as
        ``cv2.minMaxLoc`` reports it."""
        res = self.scores(templ)
        y, x = divmod(int(np.argmax(res)), res.shape[1])
        return float(res[y, x]), (x, y)


def match_template_ccoeff_normed(image: np.ndarray, templ: np.ndarray
                                 ) -> np.ndarray:
    """``cv2.matchTemplate(image, templ, cv2.TM_CCOEFF_NORMED)`` for 2-D
    uint8 images (:meth:`TemplateMatcher.scores`)."""
    return TemplateMatcher(image).scores(templ)


def match_template_best(image: np.ndarray, templ: np.ndarray
                        ) -> Tuple[float, Tuple[int, int]]:
    """``cv2.minMaxLoc``'s maximum of :func:`match_template_ccoeff_normed`:
    (score, (x, y))."""
    return TemplateMatcher(image).best(templ)
