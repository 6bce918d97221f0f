"""The port's profile / probe kernels and scripts against the JAX package's.

``fused_ln_matmul`` and every mode of ``attention_variant`` run on the CPU,
where they take their plain PyTorch versions, and are compared with the JAX
functions on the same numpy inputs: ``mmer_tpu.ops.fused_blocks.fused_ln_matmul``
in interpret mode, and ``scripts.probe_attn.run_variant``, whose
``pl.pallas_call`` passes no ``interpret=`` and is therefore wrapped here to
add it (the script file is not edited).  Float32 tolerances cover summation
order only; the bf16 cases pin the rounding points against the kernel body
run op by op (``jax.disable_jit``), because XLA's CPU compiler keeps excess
precision inside a fused interpret-mode body.

The CUDA kernels are held to the same plain versions on a GPU by
tests/test_torch_cuda.py and chip_smoke.py.
"""

import math

import flax.linen as fnn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import scripts.probe_attn as jax_probe
from mmer_tpu.ops import fused_blocks as jax_blocks
from mmer_tpu_torch.ops import attention_variants as av
from mmer_tpu_torch.ops.attention_variants import (MODES, VALID_MODES,
                                                   attention_variant,
                                                   attention_variant_reference,
                                                   variant_operands)
from mmer_tpu_torch.ops.fused_blocks import (fused_ln_matmul, layer_norm,
                                             ln_matmul_reference)
from mmer_tpu_torch.scripts import (probe_attn, profile_fused_blocks,
                                    profile_train, profile_vivit, profile_w2v2)

from torch_threads import few_threads  # noqa: F401


def _t(a, dtype=torch.float32):
    return torch.from_numpy(np.asarray(a, np.float32)).to(dtype)


# -- fused LN + matmul ---------------------------------------------------------

def _ln_matmul_inputs(seed, b, s, d, n):
    rng = np.random.default_rng(seed)
    f = np.float32
    return dict(x=rng.normal(size=(b, s, d)).astype(f),
                scale=(rng.normal(size=(d,)) * 0.1 + 1.0).astype(f),
                bias=(rng.normal(size=(d,)) * 0.1).astype(f),
                w=(rng.normal(size=(d, n)) * 0.05).astype(f))


def _port_ln_matmul(p, dtype=torch.float32):
    # The port takes the nn.Linear layout: w (N, D).
    return fused_ln_matmul(_t(p["x"], dtype), _t(p["scale"]), _t(p["bias"]),
                           _t(p["w"].T, dtype).contiguous())


@pytest.mark.parametrize("shape", [(2, 37, 64, 192), (1, 50, 32, 64)])
def test_ln_matmul_matches_pallas_interpret(shape):
    p = _ln_matmul_inputs(1, *shape)
    want = jax_blocks.fused_ln_matmul(*(jnp.asarray(p[k]) for k in
                                        ("x", "scale", "bias", "w")),
                                      interpret=True)
    got = _port_ln_matmul(p)
    assert got.shape == want.shape and got.dtype == torch.float32
    # f32 throughout: only the order of the GEMM sums differs (the bound of
    # tests/test_fused_blocks.py).
    np.testing.assert_allclose(got.numpy(), np.asarray(want),
                               atol=2e-5, rtol=2e-5)


def test_ln_matmul_matches_flax_layernorm_times_w():
    p = _ln_matmul_inputs(2, 2, 37, 64, 192)
    y = fnn.LayerNorm(dtype=jnp.float32).apply(
        {"params": {"scale": p["scale"], "bias": p["bias"]}}, jnp.asarray(p["x"]))
    np.testing.assert_allclose(_port_ln_matmul(p).numpy(),
                               np.asarray(y @ p["w"]), atol=2e-5, rtol=2e-5)


def test_ln_matmul_bf16_rounding_points():
    """LN rounded to bf16 before the product, the f32 product rounded once,
    output in the weight's dtype whatever x's: against the Pallas kernel's
    body run op by op the port agrees to the bit but for rare flips of the
    last rounding, while a version that keeps the LN output in f32 (the
    misplaced rounding) is an order of magnitude further off."""
    p = _ln_matmul_inputs(3, 2, 37, 64, 192)
    bf = jnp.bfloat16
    x, w = jnp.asarray(p["x"]).astype(bf), jnp.asarray(p["w"]).astype(bf)
    with jax.disable_jit():
        y = jax_blocks._ln_rows(x.astype(jnp.float32), p["scale"], p["bias"])
        want = jnp.dot(y.astype(bf), w,
                       preferred_element_type=jnp.float32).astype(bf)
    want = np.asarray(want.astype(jnp.float32))

    got = _port_ln_matmul(p, torch.bfloat16)
    assert got.dtype == torch.bfloat16
    diff = np.abs(got.float().numpy() - want)
    assert float(diff.max()) <= 2 ** -7 * float(np.abs(want).max())
    assert float(diff.mean()) <= 2e-5, float(diff.mean())

    xt, wt = _t(p["x"], torch.bfloat16), _t(p["w"].T, torch.bfloat16)
    slipped = torch.matmul(layer_norm(xt, _t(p["scale"]), _t(p["bias"])),
                           wt.float().t()).to(torch.bfloat16)
    assert float(np.abs(slipped.float().numpy() - want).mean()) > 2e-4

    # f32 activations over a bf16 weight (the Wav2Vec2 stream): bf16 out.
    got32 = fused_ln_matmul(_t(p["x"]), _t(p["scale"]), _t(p["bias"]), wt)
    assert got32.dtype == torch.bfloat16
    # The interpret-mode kernel itself, at the loose bound excess precision
    # inside its fused body needs.
    kern = jax_blocks.fused_ln_matmul(x, jnp.asarray(p["scale"]),
                                      jnp.asarray(p["bias"]), w, interpret=True)
    kdiff = np.abs(got.float().numpy() - np.asarray(kern.astype(jnp.float32)))
    assert float(kdiff.max()) <= 2 ** -6 * float(np.abs(want).max())


def test_ln_matmul_reference_is_the_cpu_route():
    p = _ln_matmul_inputs(4, 1, 5, 32, 64)
    args = (_t(p["x"]), _t(p["scale"]), _t(p["bias"]), _t(p["w"].T).contiguous())
    n0 = fused_ln_matmul.launches
    assert torch.equal(fused_ln_matmul(*args), ln_matmul_reference(*args))
    assert fused_ln_matmul.launches == n0      # no kernel launch on the CPU


# -- attention variants --------------------------------------------------------

@pytest.fixture
def interpreted_probe(monkeypatch):
    """scripts.probe_attn with its pallas_call run in interpret mode."""
    real = jax_probe.pl.pallas_call
    monkeypatch.setattr(
        jax_probe.pl, "pallas_call",
        lambda *a, **kw: real(*a, **{**kw, "interpret": True}))
    return jax_probe


def _qkv(seed, shape):
    rng = np.random.default_rng(seed)
    return [rng.normal(size=shape).astype(np.float32) for _ in range(3)]


def _jax_s_pad(h, s, d, itemsize):
    """The padded length run_variant derives from its block model."""
    s_pad = jax_probe._round_up(s, 128)
    block_q, _ = jax_probe._pick_blocks(h, s_pad, d, itemsize)
    return jax_probe._round_up(s_pad, block_q)


# Rows of the two ``p = scores`` modes are compared where the plain
# denominator (a sum of signed scores) is at least this far from zero.
DEN_MIN = 1.0


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_attention_variant_matches_probe_script(interpreted_probe, mode, dtype):
    b, h, s, d = 1, 2, 50, 64          # S is not a multiple of 128
    q, k, v = _qkv(5, (b, h, s, d))
    jdt = jnp.float32 if dtype == "float32" else jnp.bfloat16
    tdt = torch.float32 if dtype == "float32" else torch.bfloat16
    want = np.asarray(interpreted_probe.run_variant(
        *(jnp.asarray(a).astype(jdt) for a in (q, k, v)), mode
    ).astype(jnp.float32))
    s_pad = _jax_s_pad(h, s, d, 4 if dtype == "float32" else 2)
    assert s_pad % 128 == 0 and s_pad > s
    got, num, den = attention_variant_reference(
        *(_t(a, tdt) for a in (q, k, v)), mode, s_pad, return_parts=True)
    assert got.shape == (b, h, s, d) and got.dtype == tdt
    got = got.float().numpy()
    keep = np.ones((b, h, s), bool)
    if mode in ("nosoftmax", "kt_nosoftmax"):
        keep = np.abs(den.numpy()[..., 0]) >= DEN_MIN
        assert keep.mean() > 0.5
    got, want = got[keep], want[keep]
    if dtype == "float32":
        # Same function, f32 throughout: summation order only.  The two
        # ``p = scores`` modes divide by a denominator as small as DEN_MIN,
        # which scales the error of their sums of ~100 terms.
        tol = 2e-4 if mode in ("nosoftmax", "kt_nosoftmax") else 2e-5
        np.testing.assert_allclose(got, want, atol=tol, rtol=tol)
    else:
        # bf16: p and the output are rounded at the same points, but the
        # interpret-mode kernel keeps excess precision inside its fused
        # body, so outputs differ by a bf16 step here and there.
        diff = np.abs(got - want)
        assert float(diff.max()) <= 2 ** -6 * float(np.abs(want).max())
        assert float(diff.mean()) <= 2 ** -8 * float(np.abs(want).mean())


def test_attention_variant_modes_relate_as_the_probe_says():
    """mxumask and kt equal full; nomask lets the zero keys take part; the
    ``p = scores`` modes do not depend on the K layout."""
    q, k, v = (_t(a) for a in _qkv(6, (2, 2, 50, 64)))
    out = {m: attention_variant(q, k, v, m, 64) for m in MODES}
    scale = 1.0 / math.sqrt(64)
    ref = torch.softmax(q @ k.transpose(-1, -2) * scale, -1) @ v
    for mode in ("full", "kt"):
        torch.testing.assert_close(out[mode], ref, atol=2e-5, rtol=2e-5)
    # mxumask: the f32 sum loses the low bits of a score next to -1e9 only
    # on padded keys, whose probability is zero either way.
    torch.testing.assert_close(out["mxumask"], ref, atol=2e-5, rtol=2e-5)
    torch.testing.assert_close(out["kt_nosoftmax"], out["nosoftmax"])
    # 14 zero keys with score 0 and value 0 take part in nomask.
    scores = torch.cat([q @ k.transpose(-1, -2) * scale,
                        torch.zeros(2, 2, 50, 14)], -1)
    vp = torch.cat([v, torch.zeros(2, 2, 14, 64)], -2)
    torch.testing.assert_close(out["nomask"], torch.softmax(scores, -1) @ vp,
                               atol=2e-5, rtol=2e-5)
    shifted = scores - scores.amax(-1, keepdim=True)
    torch.testing.assert_close(out["noexp"],
                               shifted @ vp / shifted.sum(-1, keepdim=True),
                               atol=2e-4, rtol=2e-4)
    assert not torch.allclose(out["nomask"], out["full"], atol=1e-3)


@pytest.mark.parametrize("mode", [m for m in MODES if m != "full"])
def test_variant_operands_carry_the_function(mode):
    """What the kernels are handed (rows past S read as zeros; only the
    transposed K and the 80-column q, k are materialised) defines the same
    function as the plain version."""
    s, s_pad = 50, 128
    q, k, v = (_t(a, torch.bfloat16) for a in _qkv(7, (1, 2, s, 64)))
    qo, ko, vo = variant_operands(q, k, v, mode, s_pad)
    assert vo is v
    if mode.startswith("kt"):
        assert qo is q and ko.shape == (1, 2, 64, s_pad) and ko.is_contiguous()
        assert torch.equal(ko[..., :s], k.transpose(-1, -2))
        assert not ko[..., s:].any()
    elif mode == "mxumask":
        assert qo.shape == (1, 2, s, 80) and ko.shape == (1, 2, s_pad, 80)
        assert torch.equal(qo[..., :64], q * 0.125) and torch.equal(ko[:, :, :s, :64], k)
        assert (qo[..., 64] == 1).all() and not qo[..., 65:].any()
        assert not ko[:, :, :s, 64:].any() and not ko[:, :, s:, :64].any()
        assert (ko[:, :, s:, 64] == torch.tensor(av.MASK_BIAS).bfloat16()).all()
        # An 80-deep product of these operands is the masked score matrix.
        scores = qo.float() @ ko.float().transpose(-1, -2)
        p = torch.exp(scores - scores.amax(-1, keepdim=True)).bfloat16().float()
        vp = torch.cat([v, v.new_zeros(1, 2, s_pad - s, 64)], -2).float()
        got = ((p @ vp) / p.sum(-1, keepdim=True)).bfloat16()
        assert torch.equal(got, attention_variant_reference(q, k, v, mode, s_pad))
    else:
        assert qo is q and ko is k


def test_attention_variant_rejects_bad_arguments():
    q, k, v = (_t(a) for a in _qkv(8, (1, 1, 9, 64)))
    with pytest.raises(ValueError):
        attention_variant(q, k, v, "causal")
    with pytest.raises(ValueError):
        attention_variant(q, k, v, "nomask", s_pad=8)
    assert av.default_s_pad(1569) == 1664 and av.default_s_pad(128) == 128
    assert set(attention_variant.launches) == set(MODES)
    assert set(VALID_MODES) < set(MODES)


# -- the two scripts -----------------------------------------------------------

def test_profile_fused_blocks_script_runs_on_cpu(capsys):
    rows = profile_fused_blocks.main(["--device", "cpu", "--tiny", "--inputs", "2"])
    assert [r["name"] for r in rows] == ["LN+QKV plain", "LN+QKV fused",
                                         "FFN plain", "FFN fused"]
    for r in rows:
        assert r["ms"] > 0 and r["tflops"] > 0 and r["device"] == "cpu"
        assert r["peak_share"] == pytest.approx(r["tflops"] * 1e12 / 989e12)
    assert "LN+QKV fused" in capsys.readouterr().out


def test_probe_attn_script_runs_on_cpu():
    rows = probe_attn.main(["--device", "cpu", "--tiny", "--inputs", "1"])
    assert [r["name"] for r in rows] == list(MODES)
    for r in rows:
        assert r["ms"] > 0 and r["device"] == "cpu"
        assert ("max_abs_diff_vs_flash" in r) == (r["name"] in VALID_MODES)
    by = {r["name"]: r for r in rows}
    # full, mxumask and kt are flash_attention to a bf16 rounding.
    for mode in ("full", "mxumask", "kt"):
        assert by[mode]["max_abs_diff_vs_flash"] <= 2 ** -6


def test_profile_train_script_runs_on_cpu():
    out = profile_train.main(["--device", "cpu", "--tiny", "--batch_size", "32"])
    assert out["device"] == "cpu" and out["steps_per_epoch"] == 5
    assert out["step_ms"] > 0 and "idle_share" not in out   # no device numbers


def test_profile_w2v2_script_runs_on_cpu():
    """The three legs at a tiny config: rows with host times, FLOPs that
    add up (full = conv encoder + transformer), no device numbers."""
    rows = profile_w2v2.main(["--device", "cpu", "--tiny", "--batch", "2",
                              "--inputs", "1"])
    assert [r["name"] for r in rows] == ["full", "conv encoder", "transformer"]
    for r in rows:
        assert r["ms"] > 0 and r["device"] == "cpu" and "idle_share" not in r
    flops = [r["tflops"] * r["ms"] for r in rows]
    assert flops[0] == pytest.approx(flops[1] + flops[2])


def test_profile_vivit_script_runs_on_cpu():
    """The five legs at a tiny config; the model without attention does the
    model's work less ``depth`` attention calls."""
    rows = profile_vivit.main(["--device", "cpu", "--tiny", "--batch", "2",
                               "--inputs", "1"])
    assert [r["name"] for r in rows] == [
        "model kernels", "model plain", "attention kernel", "attention plain",
        "model no attention"]
    work = {r["name"]: r["tflops"] * r["ms"] for r in rows}
    for r in rows:
        assert r["ms"] > 0 and r["device"] == "cpu" and "idle_share" not in r
    assert work["model no attention"] == pytest.approx(
        work["model kernels"] - 2 * work["attention kernel"])


@pytest.mark.parametrize("main", [profile_fused_blocks.main, probe_attn.main,
                                  profile_train.main, profile_w2v2.main,
                                  profile_vivit.main])
def test_scripts_default_to_the_card_and_raise_without_one(main):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="CUDA"):
        main(["--tiny"])
