"""``jax.random`` as the JAX package uses it, in PyTorch, and a Hopper kernel
that draws a training step's random numbers in one launch.

The JAX package draws its weights and every random number of its trainers
from threefry2x32 keys.  This module computes them as jax 0.9 does with
``jax_threefry_partitionable`` on (``jax/_src/random.py``), bit for bit:

- **threefry2x32** (20 rounds, Random123's rotations and key schedule) on
  int64 tensors masked to 32 bits; the key words may be ints or int64
  tensors (one key a row), so a batch of keys is one call.
- **Keys**: ``PRNGKey``, ``split`` (key i is the threefry of the counter
  (0, i)), ``fold_in`` (the threefry of (0, data)); ``split(key)[i]`` is
  ``fold_in(key, i)``, so every derived key is a chain of fold-ins.
  flax's ``make_rng`` folds the SHA-1 of a module path and the scope's
  counter into its collection's key (:func:`path_word`,
  :func:`fold_in_static`).
- **Bits**: an element's 32 bits are the threefry of its key and its flat
  index (high, low words), xor-ed (:func:`random_bits`).
- **Distributions**: ``uniform`` (the top 23 bits as a float in [1, 2),
  minus 1), ``bernoulli`` (``uniform < float32(p)``), ``permutation``
  (``ceil(3 ln n / ln(2**32 - 1))`` rounds of a stable sort by fresh 32-bit
  keys), ``exponential``, ``normal`` (``sqrt(2) * erf_inv`` of a uniform on
  (-1, 1)), and ``loggamma`` / ``beta`` (Marsaglia-Tsang with its two
  rejection loops, one key split a element, in log space).  Their float32
  math is XLA's CPU math op for op: Cephes ``log``, ``log1p`` and ``exp``
  in their vectorised forms, Giles' ``erf_inv``, multiply-adds contracted
  (one rounding, done in float64), denormal results of ``exp`` flushed.
  ``beta`` runs on the host: the trainer draws an epoch's λ before the
  epoch starts.

**The kernel** (``csrc/threefry.cu``) computes :func:`random_bits` and the
transforms of a step in one launch: a :class:`DrawPlan` is a table, built
once a run, of draws (a chain of fold-in words after the step's key, an
element count, and what to write: bits, a sort key, a uniform, or a keep
mask as 0 / 1 in the dtype its site applies it in); :meth:`DrawPlan.draw`
gives it the lanes' keys and the step, which the kernel folds in itself.
On a CPU tensor the plan runs its plain version (:meth:`DrawPlan.draw_plain`,
the int64 code above); on a CUDA tensor only the kernel runs, and a refused
launch raises.  :func:`random_bits` on a CUDA index goes through the same
kernel.

Threefry is counter-based and elementwise: a thread an output word, the
20 rounds in registers, one store.  The kernel's bound on this card is its
integer operations (about 90 a word), not its bytes; see PERF.md.
"""

from __future__ import annotations

import ctypes
import hashlib
import math
from typing import List, NamedTuple, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from mmer_tpu_torch.ops import _build

MASK = 0xFFFFFFFF
ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))
Key = Tuple[int, int]
Word = Union[int, torch.Tensor]

# flax 0.12's ``flax_fix_rng_separator`` default: no byte between path parts.
FIX_RNG_SEPARATOR = False

# XLA's single-precision erf_inv (M. Giles), for w = -log1p(-x*x) < 5 and >= 5.
_ERFINV_SMALL = (2.81022636e-08, 3.43273939e-07, -3.5233877e-06,
                 -4.39150654e-06, 0.00021858087, -0.00125372503,
                 -0.00417768164, 0.246640727, 1.50140941)
_ERFINV_LARGE = (-0.000200214257, 0.000100950558, 0.00134934322,
                 -0.00367342844, 0.00573950773, -0.0076224613,
                 0.00943887047, 1.00167406, 2.83297682)
# XLA's CPU log1p (Cephes): a rational form for |x| < sqrt(2) - 1 ...
_LOG1P_SMALL = 0.41421356237309504880
_LOG1P_NUM = (4.5270000862445199635215e-5, 4.9854102823193375972212e-1,
              6.5787325942061044846969e0, 2.9911919328553073277375e1,
              6.0949667980987787057556e1, 5.7112963590585538103336e1,
              2.0039553499201281259648e1)
_LOG1P_DEN = (1.0, 1.5062909083469192043167e1, 8.3047565967967209469434e1,
              2.2176239823732856465394e2, 3.0909872225312059774938e2,
              2.1642788614495947685003e2, 6.0118660497603843919306e1)
# ... and log(1 + x) elsewhere, through its vectorised Cephes logf.
_LOG_SQRTHF = float(np.float32(0.707106781186547524))
_LOG_P = tuple(float(np.float32(c)) for c in (
    7.0376836292e-2, -1.1514610310e-1, 1.1676998740e-1, -1.2420140846e-1,
    1.4249322787e-1, -1.6668057665e-1, 2.0000714765e-1, -2.4999993993e-1,
    3.3333331174e-1))
_LOG_Q1, _LOG_Q2 = float(np.float32(-2.12194440e-4)), float(np.float32(0.693359375))
# XLA's CPU exp (Cephes expf in its vectorised form).
_EXP_LOG2E = float(np.float32(1.44269504088896341))
_EXP_C1, _EXP_C2 = float(np.float32(0.693359375)), float(np.float32(-2.12194440e-4))
_EXP_P = tuple(float(np.float32(c)) for c in (
    1.9875691500e-4, 1.3981999507e-3, 8.3334519073e-3, 4.1665795894e-2,
    1.6666665459e-1, 5.0000001201e-1))
_EXP_LO, _EXP_HI = float(np.float32(-87.8)), float(np.float32(88.8))
_F32_TINY = float(np.finfo(np.float32).tiny)


def _f32(bits: int) -> float:
    return float(np.array(bits, np.uint32).view(np.float32))


# -- threefry and keys ------------------------------------------------------------

def threefry2x32(key: Tuple[Word, Word], x0: torch.Tensor, x1: torch.Tensor):
    """Threefry-2x32 of the counter words (x0, x1), int64 tensors of values
    below 2**32, under ``key`` (two ints, or two int64 tensors that
    broadcast with the counters); every sum is masked back to 32 bits.  The
    inputs are not modified."""
    k0, k1 = key
    ks = (k0, k1, k0 ^ k1 ^ 0x1BD11BDA)
    x0 = x0.add(ks[0]).bitwise_and_(MASK)
    x1 = x1.add(ks[1]).bitwise_and_(MASK)
    if x0.shape != x1.shape:
        shape = torch.broadcast_shapes(x0.shape, x1.shape)
        x0, x1 = x0.expand(shape).clone(), x1.expand(shape).clone()
    high = torch.empty_like(x1)
    for i in range(5):
        for r in ROTATIONS[i % 2]:
            x0.add_(x1).bitwise_and_(MASK)
            torch.bitwise_left_shift(x1, r, out=high).bitwise_and_(MASK)
            x1.bitwise_right_shift_(32 - r).bitwise_or_(high).bitwise_xor_(x0)
        x0.add_(ks[(i + 1) % 3]).bitwise_and_(MASK)
        x1.add_(ks[(i + 2) % 3] + i + 1).bitwise_and_(MASK)
    return x0, x1


def _key_words(key: Key, counters: Sequence[int]) -> list:
    """The keys ``threefry2x32(key, (0, c))`` for each counter ``c``, on the
    host."""
    c = torch.tensor(list(counters), dtype=torch.int64)
    y0, y1 = threefry2x32(key, c >> 32, c & MASK)
    return list(zip(y0.tolist(), y1.tolist()))


def PRNGKey(seed: int) -> Key:  # noqa: N802 -- jax's name
    """``jax.random.PRNGKey(seed)`` with 64-bit mode off: the seed as a
    32-bit word (a negative one wraps), high word 0."""
    seed = int(seed)
    if not -2 ** 31 <= seed < 2 ** 32:
        raise ValueError(f"seed {seed} does not fit 32 bits, as jax's "
                         "default (64-bit mode off) requires")
    return (0, seed & MASK)


def split(key: Key, num: int = 2) -> list:
    """``jax.random.split(key, num)``: key i is the threefry of counter
    (0, i)."""
    return _key_words(key, range(num))


def fold_in(key: Key, data: int) -> Key:
    """``jax.random.fold_in(key, data)``: the threefry of (0, data)."""
    return _key_words(key, [int(data) & MASK])[0]


def fold_in_many(keys: Tuple[torch.Tensor, torch.Tensor], data: Word
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """``fold_in`` of a batch of keys (two int64 tensors of words), each
    with ``data`` (an int, or an int64 tensor, one word a key)."""
    data = torch.as_tensor(data, dtype=torch.int64).bitwise_and(MASK)
    return threefry2x32(keys, torch.zeros_like(data), data)


def random_bits(key: Key, index: torch.Tensor) -> torch.Tensor:
    """``jax.random.bits(key, shape)`` (32 bits) at the flat row-major
    indices ``index`` (int64) of ``shape``, as int64 values below 2**32.  On
    a CUDA tensor one launch of the threefry kernel draws them."""
    if index.is_cuda:
        plan = DrawPlan([Draw((), (index.numel(),), "bits")], index.device,
                        index=index.reshape(-1))
        return plan.draw([key])[0].reshape(index.shape)
    return random_bits_plain(key, index)


def path_word(parts: Sequence, separator: bool = FIX_RNG_SEPARATOR) -> int:
    """``flax.core.scope._fold_in_static``'s word: the first four bytes,
    big-endian, of the SHA-1 of a module path and a per-scope counter
    (strings as UTF-8, ints as their shortest big-endian bytes)."""
    m = hashlib.sha1()
    for x in parts:
        if separator:
            m.update(b"\x00")
        if isinstance(x, str):
            m.update(x.encode("utf-8"))
        elif isinstance(x, int):
            m.update(x.to_bytes((x.bit_length() + 7) // 8, byteorder="big"))
        else:
            raise ValueError(f"expected an int or a str, got {x!r}")
    return int.from_bytes(m.digest()[:4], byteorder="big")


def fold_in_static(key: Key, parts: Sequence, separator: bool = FIX_RNG_SEPARATOR
                   ) -> Key:
    """``flax.core.scope._fold_in_static``: fold :func:`path_word` of a
    module path and a per-scope counter into ``key``."""
    if not parts:
        return key
    return fold_in(key, path_word(parts, separator))


def shuffle_rounds(n: int) -> int:
    """The sort rounds of ``jax.random.permutation`` over ``n`` elements:
    ``ceil(3 ln n / ln(2**32 - 1))``."""
    return int(np.ceil(3 * np.log(max(1, n)) / np.log(np.iinfo(np.uint32).max)))


# -- float32 transforms, as XLA's CPU backend computes them ----------------------

def _unit_uniform(bits: torch.Tensor) -> torch.Tensor:
    """[0, 1) from the top 23 bits: ``bits >> 9 | 0x3F800000`` read as a
    float in [1, 2), minus 1 (exact)."""
    return ((bits >> 9) | 0x3F800000).to(torch.int32).view(torch.float32) - 1.0


def _fma(a, b, c) -> torch.Tensor:
    """``a*b + c`` with one float32 rounding, as XLA's contracted multiply-add
    gives it: the product of two floats is exact in float64."""
    return (torch.as_tensor(a).double() * torch.as_tensor(b).double()
            + torch.as_tensor(c).double()).float()


# float32 quotients and square roots through float64, which rounds them
# correctly (53 >= 2*24 + 2 bits): torch's float32 CPU sqrt has been seen to
# take a low-precision path on part of a tensor.
def _div(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return (torch.as_tensor(a).double() / torch.as_tensor(b).double()).float()


def _sqrt(a: torch.Tensor) -> torch.Tensor:
    return torch.sqrt(a.double()).float()


def _horner(coeffs, x: torch.Tensor) -> torch.Tensor:
    p = torch.zeros_like(x)
    for c in coeffs:
        p = _fma(p, x, float(np.float32(c)))
    return p


def _xla_log(x: torch.Tensor) -> torch.Tensor:
    """XLA's CPU float32 ``log`` (Cephes ``logf`` in its vectorised form,
    multiply-adds contracted): exact for positive normal ``x``; -inf at 0."""
    bits = x.view(torch.int32)
    frac = ((bits & ~0x7F800000) | 0x3F000000).view(torch.float32)   # [0.5, 1)
    e = 1.0 + ((bits >> 23) - 0x7F).float()
    low = frac < _LOG_SQRTHF
    e = e - low.float()
    m = (frac - 1.0) + torch.where(low, frac, torch.zeros_like(frac))
    m2 = m * m
    m3 = m2 * m
    p = _LOG_P
    y = _fma(_fma(m, p[0], p[1]), m, p[2])
    y1 = _fma(_fma(m, p[3], p[4]), m, p[5])
    y2 = _fma(_fma(m, p[6], p[7]), m, p[8])
    y = _fma(_fma(y, m3, y1), m3, y2)
    y = _fma(y, m3, _LOG_Q1 * e)
    out = _fma(-0.5, m2, m) + y
    out = _fma(_LOG_Q2, e, out)
    return torch.where(x == 0, -math.inf, out)


def _xla_log1p(x: torch.Tensor) -> torch.Tensor:
    """XLA's CPU float32 ``log1p`` on (-1, 0]: Cephes' rational form below
    |x| = sqrt(2) - 1, else ``log(1 + x)``."""
    x2 = x * x
    small = _div(_horner(_LOG1P_NUM, x), _horner(_LOG1P_DEN, x))
    small = x + _fma(-0.5, x2, (x * x2) * small)
    return torch.where(x.abs() < _LOG1P_SMALL, small, _xla_log(x + 1.0))


def _xla_exp(x: torch.Tensor) -> torch.Tensor:
    """XLA's CPU float32 ``exp`` (Cephes ``expf`` in its vectorised form,
    multiply-adds contracted): ``x`` clamped to [-87.8, 88.8], ``e^a * 2^n``
    with ``n = floor(x log2(e) + 1/2)``, a degree-5 polynomial for ``e^a``;
    a result below the smallest normal float is flushed to 0."""
    x = x.clamp(_EXP_LO, _EXP_HI)
    n = torch.floor(_fma(x, _EXP_LOG2E, 0.5)).clamp(-127.0, 127.0)
    a = _fma(-_EXP_C2, n, _fma(-_EXP_C1, n, x))
    z = _fma(a, _EXP_P[0], _EXP_P[1])
    for p in _EXP_P[2:]:
        z = _fma(z, a, p)
    z = 1.0 + _fma(z, a * a, a)
    ni = n.to(torch.int32)
    pow2 = torch.where(ni > -127, ((ni + 127) << 23).view(torch.float32),
                       torch.zeros_like(z))
    out = z * pow2
    return torch.where(out.abs() < _F32_TINY, torch.zeros_like(out), out)


def erf_inv(x: torch.Tensor) -> torch.Tensor:
    """XLA's float32 ``erf_inv``: Giles' polynomial over
    ``w = -log1p(-x*x)``, each step one float32 rounding; +-inf at +-1."""
    w = -_xla_log1p(-(x * x))
    small = w < 5.0
    w = torch.where(small, w - 2.5, _sqrt(w) - 3.0)
    p = torch.zeros_like(x)
    for cs, cl in zip(_ERFINV_SMALL, _ERFINV_LARGE):
        p = _fma(p, w, torch.where(small, float(np.float32(cs)),
                                   float(np.float32(cl))))
    return torch.where(x.abs() == 1.0, x * math.inf, p * x)


_SQRT2 = float(np.float32(np.sqrt(2.0)))
_SQUEEZE = float(np.float32(0.0331))     # Marsaglia-Tsang's squeeze


# -- distributions ----------------------------------------------------------------

def _flat(shape, device) -> torch.Tensor:
    return torch.arange(math.prod(shape), dtype=torch.int64, device=device)


def uniform(key: Key, shape: Sequence[int], device="cpu") -> torch.Tensor:
    """``jax.random.uniform(key, shape, float32)`` on [0, 1)."""
    return _unit_uniform(random_bits(key, _flat(shape, device))).reshape(shape)


def bernoulli(key: Key, p: float, shape: Sequence[int], device="cpu"
              ) -> torch.Tensor:
    """``jax.random.bernoulli(key, p, shape)``: ``uniform < float32(p)``."""
    return uniform(key, shape, device) < float(np.float32(p))


def exponential(key: Key, shape: Sequence[int], device="cpu") -> torch.Tensor:
    """``jax.random.exponential(key, shape, float32)``: ``-log1p(-u)``."""
    return -_xla_log1p(-uniform(key, shape, device))


def normal(key: Key, index: torch.Tensor, scale: float = 1.0,
           jitted: bool = False) -> torch.Tensor:
    """``jax.random.normal(key, shape, float32) * scale`` at flat ``index``:
    a uniform on (nextafter(-1, 0), 1), then ``sqrt(2) * erf_inv``, then the
    scale (flax's ``normal(stddev)``).  Under ``jax.jit`` XLA folds the two
    constants into one, ``f32(sqrt(2) * scale)``, and rounds once less
    (``jitted``); eagerly each multiply rounds."""
    return _normal_of_bits(random_bits(key, index), scale, jitted)


def _normal_of_bits(bits: torch.Tensor, scale: float = 1.0,
                    jitted: bool = False) -> torch.Tensor:
    lo = float(np.nextafter(np.float32(-1.0), np.float32(0.0)))
    # (1 - lo) rounds to 2 in float32, so u*2 is exact and the add rounds once.
    u = torch.clamp_min(_unit_uniform(bits) * 2.0 + lo, lo)
    scale = float(np.float32(scale))
    if jitted:
        return erf_inv(u) * float(np.float32(_SQRT2) * np.float32(scale))
    return _SQRT2 * erf_inv(u) * scale


def permutation(key: Key, n: int, device="cpu") -> torch.Tensor:
    """``jax.random.permutation(key, n)``: :func:`shuffle_rounds` rounds,
    each ``key, sub = split(key)`` and a stable sort of the running order
    by ``random_bits(sub, (n,))``.  On a CUDA device one launch draws every
    round's sort keys."""
    return permute_by_keys(
        DrawPlan(permutation_draws((), n), device).draw([key]))


def permutation_draws(chain: Tuple[int, ...], n: int) -> List["Draw"]:
    """The sort-key draws of ``permutation(k, n)``, for ``k`` the key that
    ``chain`` folds in: round r sorts by the bits of ``chain + (0,)*r + (1,)``
    (``split(key)[1]`` is ``fold_in(key, 1)``)."""
    return [Draw(tuple(chain) + (0,) * r + (1,), (n,), "sortkey")
            for r in range(shuffle_rounds(n))]


def permute_by_keys(sort_keys: Sequence[torch.Tensor]) -> torch.Tensor:
    """The permutation that stable sorts by each round's keys in turn
    (int32 sort keys of :class:`DrawPlan`, ``(..., n)``)."""
    if not sort_keys:
        raise ValueError("a permutation of fewer than two elements has no "
                         "sort keys; it is the identity")
    order = None
    for keys in sort_keys:
        step = torch.sort(keys, dim=-1, stable=True).indices
        order = step if order is None else torch.gather(order, -1, step)
    return order


def loggamma_many(keys: Tuple[torch.Tensor, torch.Tensor],
                  alpha: torch.Tensor) -> torch.Tensor:
    """``jax.random.loggamma`` of one key a element (``_gamma_one`` with
    ``log_space=True``) for a batch of keys (two int64 tensors of words) and
    float32 ``alpha``, on the host: Marsaglia-Tsang, ``alpha < 1`` boosted
    to ``alpha + 1`` and corrected by ``log(u) / alpha``."""
    alpha = alpha.float()
    one_third = float(np.float32(1.0 / 3.0))
    boost = alpha >= 1.0
    d = torch.where(boost, alpha, alpha + 1.0) - one_third
    c = _div(torch.full_like(d, one_third), _sqrt(d))
    key, sub = fold_in_many(keys, 0), fold_in_many(keys, 1)
    n = alpha.shape[0]
    big_v = torch.ones(n)
    todo = torch.arange(n)
    while todo.numel():                       # the accept / reject loop
        k = (key[0][todo], key[1][todo])
        key_next, x_key, u_key = (fold_in_many(k, i) for i in range(3))
        cc = c[todo]
        x = torch.zeros(len(todo))
        v = torch.full((len(todo),), -1.0)
        inner = torch.arange(len(todo))
        while inner.numel():                  # v = 1 + x c > 0
            kk = (x_key[0][inner], x_key[1][inner])
            x_key[0][inner], x_key[1][inner] = fold_in_many(kk, 0)
            z = torch.zeros(len(inner), dtype=torch.int64)
            bits = torch.bitwise_xor(*threefry2x32(fold_in_many(kk, 1), z, z))
            x[inner] = _normal_of_bits(bits)
            v[inner] = _fma(x[inner], cc[inner], 1.0)
            inner = inner[v[inner] <= 0.0]
        z = torch.zeros(len(todo), dtype=torch.int64)
        u = _unit_uniform(torch.bitwise_xor(*threefry2x32(u_key, z, z)))
        xx = x * x
        vv = (v * v) * v
        dd = d[todo]
        reject = ((u >= _fma(-_SQUEEZE, xx * xx, 1.0))
                  & (_xla_log(u) >= _fma(xx, 0.5, dd * ((1.0 - vv) + _xla_log(vv)))))
        key[0][todo], key[1][todo] = key_next
        big_v[todo] = vv
        todo = todo[reject]
    z = torch.zeros(n, dtype=torch.int64)
    u = _unit_uniform(torch.bitwise_xor(*threefry2x32(sub, z, z)))
    log_u = _xla_log1p(-u)                    # -exponential(sub)
    log_boost = torch.where(boost | (log_u == 0), torch.zeros_like(u),
                            log_u * _div(torch.ones_like(alpha), alpha))
    # ``alpha`` is a constant of the jitted step, so XLA folds ``log(d)`` at
    # compile time, correctly rounded, not with the vectorised Cephes log.
    log_d = torch.log(d.double()).float()
    return (log_d + _xla_log(big_v)) + log_boost


def beta_many(keys: Tuple[torch.Tensor, torch.Tensor], a: float, b: float
              ) -> np.ndarray:
    """``jax.random.beta(key, a, b)`` (a float32 scalar a key) for a batch
    of keys, on the host: ``key_a, key_b = split(key)``, a log-gamma draw
    each (the key split once more, per element), and
    ``exp(la - m) / (exp(la - m) + exp(lb - m))`` with ``m = max(la, lb)``."""
    n = keys[0].shape[0]
    if n == 0:
        return np.zeros(0, np.float32)

    def log_gamma(i: int, shape: float) -> torch.Tensor:
        k = fold_in_many(fold_in_many(keys, i), 0)   # split(key_i, 1)[0]
        return loggamma_many(k, torch.full((n,), float(np.float32(shape))))

    la, lb = log_gamma(0, a), log_gamma(1, b)
    m = torch.maximum(la, lb)
    ga, gb = _xla_exp(la - m), _xla_exp(lb - m)
    return _div(ga, ga + gb).numpy()


def beta(key: Key, a: float, b: float) -> np.float32:
    """``jax.random.beta(key, a, b)``, a float32 scalar, on the host."""
    k = tuple(torch.tensor([w], dtype=torch.int64) for w in key)
    return beta_many(k, a, b)[0]


# -- the kernel: every draw of a step in one launch ---------------------------------

class Draw(NamedTuple):
    """One draw of a :class:`DrawPlan`: the key is the step's key (or a
    lane's key) with the ``chain`` words folded in, in turn; ``shape`` its
    elements; ``kind`` what each element's bits become: "bits" (int64 below
    2**32), "sortkey" (int32 ``bits - 2**31``, which sorts as the bits do),
    "uniform" (float32 on [0, 1)) or "mask" (``uniform < float32(keep)`` as
    0 / 1 in ``dtype``)."""
    chain: Tuple[int, ...]
    shape: Tuple[int, ...]
    kind: str
    keep: float = 1.0
    dtype: torch.dtype = torch.float32


KINDS = {"bits": 0, "sortkey": 1, "uniform": 2, "mask_f32": 3, "mask_bf16": 4}
MAX_CHAIN = 8          # fold-in words a draw's key may take
MAX_LANES = 16         # keys of one launch
MAX_SEGMENTS = 128     # (draw, lane) pairs of one launch
_FIELDS = 16           # int64 words a segment of the table takes
ALIGN = 16             # byte alignment of each output


def _kind(d: Draw) -> int:
    if d.kind == "mask":
        if d.dtype == torch.float32:
            return KINDS["mask_f32"]
        if d.dtype == torch.bfloat16:
            return KINDS["mask_bf16"]
        raise ValueError(f"a mask is float32 or bfloat16, got {d.dtype}")
    if d.kind not in KINDS:
        raise ValueError(f"unknown draw kind {d.kind!r}")
    return KINDS[d.kind]


def _out_dtype(d: Draw) -> torch.dtype:
    return {"bits": torch.int32, "sortkey": torch.int32,
            "uniform": torch.float32}.get(d.kind, d.dtype)


class DrawPlan:
    """A fixed set of draws on ``device``, made for ``lanes`` keys at once
    (``None``: one key, and outputs without a lane axis).  The table is
    built and copied to the device once; :meth:`draw` is one kernel launch
    on CUDA and :meth:`draw_plain` the same numbers in plain int64 PyTorch.
    ``index`` (one draw, kind "bits", one lane): flat indices to draw at
    instead of ``range(n)``."""

    def __init__(self, draws: Sequence[Draw], device, lanes: Optional[int] = None,
                 index: Optional[torch.Tensor] = None):
        self.draws = list(draws)
        self.device = torch.device(device)
        self.lanes = lanes
        self.index = index
        n_lanes = lanes or 1
        if not 1 <= n_lanes <= MAX_LANES:
            raise ValueError(f"DrawPlan: 1 to {MAX_LANES} lanes, got {n_lanes}")
        if index is not None and (len(self.draws) != 1 or lanes is not None
                                  or self.draws[0].kind != "bits"
                                  or index.dtype != torch.int64
                                  or index.device != self.device):
            raise ValueError("DrawPlan: an index takes one 'bits' draw, one "
                             "lane, int64 on the plan's device")
        rows, self.offsets, start, offset = [], [], 0, 0
        for d in self.draws:
            if len(d.chain) > MAX_CHAIN:
                raise ValueError(f"DrawPlan: at most {MAX_CHAIN} fold-in words "
                                 f"a draw, got {len(d.chain)}")
            n = math.prod(d.shape)
            size = n * torch.empty((), dtype=_out_dtype(d)).element_size()
            self.offsets.append(offset)
            for lane in range(n_lanes):
                keep_bits = int(np.array(np.float32(d.keep)).view(np.uint32))
                row = [lane, n, start, offset + lane * size, _kind(d), keep_bits,
                       0 if index is None else index.data_ptr(), len(d.chain)]
                row += [w & MASK for w in d.chain] + [0] * (MAX_CHAIN - len(d.chain))
                rows.append(row)
                start += n
            offset += -(-(size * n_lanes) // ALIGN) * ALIGN
        if len(rows) > MAX_SEGMENTS:
            raise ValueError(f"DrawPlan: at most {MAX_SEGMENTS} draws x lanes "
                             f"a launch, got {len(rows)}")
        self.total, self.nbytes = start, offset
        self.table = torch.tensor(rows, dtype=torch.int64).reshape(
            -1, _FIELDS).to(self.device)

    def _views(self, out: torch.Tensor) -> List[torch.Tensor]:
        res = []
        for d, off in zip(self.draws, self.offsets):
            dt = _out_dtype(d)
            n = math.prod(d.shape) * (self.lanes or 1)
            v = out[off:off + n * torch.empty((), dtype=dt).element_size()]
            v = v.view(dt).reshape(((self.lanes,) if self.lanes else ()) + tuple(d.shape))
            res.append(v.to(torch.int64) & MASK if d.kind == "bits" else v)
        return res

    def _check_keys(self, keys: Sequence[Key]) -> None:
        if len(keys) != (self.lanes or 1):
            raise ValueError(f"DrawPlan: {self.lanes or 1} keys, got {len(keys)}")

    def draw(self, keys: Sequence[Key], step: Optional[int] = None
             ) -> List[torch.Tensor]:
        """Every draw for the lanes' ``keys`` (``step`` given: each key is
        ``fold_in(key, step)`` first), as tensors on the plan's device: one
        launch of the threefry kernel on CUDA, the plain version on the
        CPU."""
        self._check_keys(keys)
        if self.device.type == "cpu":
            return self.draw_plain(keys, step)
        if self.device.type != "cuda":
            raise ValueError(f"DrawPlan: no kernel for device {self.device}")
        out = torch.empty(self.nbytes, dtype=torch.uint8, device=self.device)
        if self.total:
            launch_threefry(self.table, keys, step, self.total, out)
        return self._views(out)

    def draw_plain(self, keys: Sequence[Key], step: Optional[int] = None
                   ) -> List[torch.Tensor]:
        """:meth:`draw` in plain int64 PyTorch on the plan's device (the
        kernel's plain version)."""
        self._check_keys(keys)
        res = []
        for d in self.draws:
            lanes = []
            for key in keys:
                if step is not None:
                    key = fold_in(key, step)
                for w in d.chain:
                    key = fold_in(key, w)
                idx = (self.index if self.index is not None
                       else _flat(d.shape, self.device))
                bits = random_bits_plain(key, idx).reshape(d.shape)
                if d.kind == "bits":
                    lanes.append(bits)
                elif d.kind == "sortkey":
                    lanes.append((bits - 2 ** 31).to(torch.int32))
                elif d.kind == "uniform":
                    lanes.append(_unit_uniform(bits))
                else:
                    _kind(d)
                    lanes.append((_unit_uniform(bits) < float(np.float32(d.keep))
                                  ).to(d.dtype))
            res.append(torch.stack(lanes) if self.lanes else lanes[0])
        return res


def random_bits_plain(key: Key, index: torch.Tensor) -> torch.Tensor:
    """:func:`random_bits` in int64 PyTorch on ``index``'s device."""
    y0, y1 = threefry2x32(key, index >> 32, index & MASK)
    return y0 ^ y1


# mmer_threefry(table, n_seg, keys, n_keys, fold_step, step, total, out, stream)
_ARGTYPES = [ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p, ctypes.c_int,
             ctypes.c_int, ctypes.c_uint32, ctypes.c_longlong, ctypes.c_void_p,
             ctypes.c_void_p]


def launch_threefry(table: torch.Tensor, keys: Sequence[Key],
                    step: Optional[int], total: int, out: torch.Tensor) -> None:
    """One launch of ``csrc/threefry.cu``: ``table`` (int64, ``(segments,
    16)``, on the card) says what to draw, ``keys`` (host words, one a lane)
    from which keys, ``step`` (or None) is folded into each key first, and
    ``out`` (uint8 on the card) receives ``total`` elements."""
    if not (table.is_cuda and out.is_cuda and table.dtype == torch.int64
            and out.dtype == torch.uint8 and table.is_contiguous()
            and table.dim() == 2 and table.shape[1] == _FIELDS):
        raise ValueError("launch_threefry: an int64 (segments, 16) table and a "
                         "uint8 output, contiguous on the card")
    if not 1 <= table.shape[0] <= MAX_SEGMENTS or not 1 <= len(keys) <= MAX_LANES:
        raise ValueError(f"launch_threefry: 1 to {MAX_SEGMENTS} segments and 1 "
                         f"to {MAX_LANES} keys")
    words = (ctypes.c_uint32 * (2 * len(keys)))(*[w & MASK for k in keys for w in k])
    _build.call("threefry", "mmer_threefry", _ARGTYPES,
                _build.ptr(table), table.shape[0], ctypes.cast(words, ctypes.c_void_p),
                len(keys), int(step is not None), (step or 0) & MASK, total,
                _build.ptr(out), _build.stream_ptr(out.device))
    launch_threefry.launches += 1


launch_threefry.launches = 0
