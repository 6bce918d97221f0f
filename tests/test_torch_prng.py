"""``mmer_tpu_torch/ops/prng.py`` and the trainers' key schedules
(``train/keys.py``) against ``jax.random`` and flax on the CPU.

Bits, uniforms, Bernoulli masks, permutations, ``split`` / ``fold_in``
chains and the 11 dropout masks of a flax training forward are compared bit
for bit.  ``beta`` is compared where the trainer draws it (inside a jitted
``lax.scan``, its ``α`` a constant): bit for bit, 0 ulp, on 1,000 keys at
each ``α``.  The kernel's plain version (``DrawPlan.draw_plain``) is what
runs here; ``tests/test_torch_cuda.py`` holds the kernel to it on a card.

The file also writes the committed fixture that ``chip_smoke.py`` holds the
card's draws to (JAX's draws of both schedules, no JAX on the card):

    JAX_PLATFORMS=cpu python tests/test_torch_prng.py --write
"""

from __future__ import annotations

import hashlib
import json
import os
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if __name__ == "__main__":          # run as the fixture writer
    sys.path.insert(0, REPO)

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import flax
import flax.linen as nn
import mmer_tpu.config as jax_config
from mmer_tpu.models.fusion import MultimodalEmotionModel as JaxFusion
import mmer_tpu_torch.config as port_config
from mmer_tpu_torch.models.fusion import _dropout_sites, dropout_draws
from mmer_tpu_torch.ops import prng
from mmer_tpu_torch.train import checkpoint as port_ckpt
from mmer_tpu_torch.train import keys as port_keys

from torch_threads import few_threads  # noqa: F401

CPU = torch.device("cpu")
ALPHAS = (0.2, 0.4, 1.0, 2.0)
# The narrow model's 11 dropout sites (two fusion layers): the shapes a
# forward of a (8, 3) batch draws, at the default rate.
NARROW = dict(max_seq_len=4, fusion_layers=2, fusion_heads=2, fused_dim=32,
              fusion_ffn_dim=64, classifier_hidden_dim=32)


def _words(key) -> tuple:
    return tuple(int(w) for w in np.asarray(key).tolist())


# -- keys, bits and the simple distributions -----------------------------------------

def test_split_and_fold_in_chains_bit_equal():
    """Ten levels of split / fold_in, each derived key equal to jax's."""
    key, ours = jax.random.PRNGKey(9), prng.PRNGKey(9)
    for level in range(10):
        if level % 2:
            key, ours = jax.random.fold_in(key, 1000 + level), prng.fold_in(ours, 1000 + level)
        else:
            key, ours = jax.random.split(key, 3)[2], prng.split(ours, 3)[2]
        assert _words(key) == ours
    many = jax.vmap(lambda k: jax.random.fold_in(k, 101))(jax.random.split(key, 50))
    mine = prng.fold_in_many(tuple(torch.tensor(c, dtype=torch.int64) for c in zip(
        *prng.split(ours, 50))), 101)
    assert [_words(k) for k in many] == list(zip(*[t.tolist() for t in mine]))


def test_bits_uniform_bernoulli_exponential_bit_equal():
    key, ours = jax.random.PRNGKey(42), prng.PRNGKey(42)
    n = 100_003
    np.testing.assert_array_equal(
        prng.random_bits(ours, torch.arange(n)).numpy().astype(np.uint32),
        np.asarray(jax.random.bits(key, (n,)), np.uint32))
    np.testing.assert_array_equal(prng.uniform(ours, (n,)).numpy(),
                                  np.asarray(jax.random.uniform(key, (n,))))
    for p in (0.9, 0.8, 0.5):
        np.testing.assert_array_equal(
            prng.bernoulli(ours, p, (7, 1001)).numpy(),
            np.asarray(jax.random.bernoulli(key, p, (7, 1001))))
    np.testing.assert_array_equal(prng.exponential(ours, (n,)).numpy(),
                                  np.asarray(jax.random.exponential(key, (n,))))


@pytest.mark.parametrize("n", [1, 2, 64, 6796])
def test_permutation_bit_equal(n):
    """``ceil(3 ln n / ln(2^32 - 1))`` rounds (0, 1, 1, 2 here) of a stable
    sort by fresh 32-bit keys."""
    key = jax.random.PRNGKey(7)
    want = np.asarray(jax.random.permutation(key, n))
    rounds = prng.shuffle_rounds(n)
    assert rounds == {1: 0, 2: 1, 64: 1, 6796: 2}[n]
    got = (prng.permutation(prng.PRNGKey(7), n) if rounds
           else torch.arange(n))
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("alpha", ALPHAS)
def test_beta_bit_equal_where_the_trainer_draws_it(alpha):
    """``beta(fold_in(key, 101), α, α)`` as the fused trainer's step draws
    it (a jitted ``lax.scan``, ``α`` a constant), for 1,000 keys: bit for
    bit (the bound is 0 ulp).  XLA folds the constant ``log(d)`` at compile
    time, correctly rounded; the loop's ``log`` and ``exp`` are its
    vectorised Cephes forms."""
    keys = jax.random.split(jax.random.PRNGKey(3), 1000)
    want = np.asarray(jax.jit(lambda ks: jax.lax.scan(
        lambda c, k: (c, jax.random.beta(jax.random.fold_in(k, 101), alpha,
                                         alpha)), 0, ks)[1])(keys))
    words = np.asarray(keys).astype(np.int64)
    k101 = prng.fold_in_many((torch.from_numpy(words[:, 0].copy()),
                              torch.from_numpy(words[:, 1].copy())), 101)
    got = prng.beta_many(k101, alpha, alpha)
    ulps = np.abs(got.view(np.int32).astype(np.int64) - want.view(np.int32))
    assert int(ulps.max()) == 0, f"{int((ulps > 0).sum())} draws differ"
    assert prng.beta(_words(jax.random.fold_in(keys[5], 101)), alpha, alpha) == want[5]


def test_xla_exp_and_log_bit_equal():
    """The Cephes ``exp`` and ``log`` of XLA's CPU backend, a denormal
    ``exp`` flushed to 0."""
    rng = np.random.default_rng(0)
    x = np.concatenate([-np.abs(rng.standard_normal(200_000)) * 20,
                        [0.0, -87.5, -87.2, -90.0]]).astype(np.float32)
    np.testing.assert_array_equal(prng._xla_exp(torch.from_numpy(x)).numpy(),
                                  np.asarray(jax.jit(jnp.exp)(x)))
    y = np.concatenate([rng.uniform(1e-7, 1, 200_000), rng.uniform(1, 50, 1000),
                        [0.0, 1.0]]).astype(np.float32)
    np.testing.assert_array_equal(prng._xla_log(torch.from_numpy(y)).numpy(),
                                  np.asarray(jax.jit(jnp.log)(y)))


# -- flax's dropout masks --------------------------------------------------------------

def _flax_masks(cfg, video, audio, mask, step_key) -> list:
    """Every mask one ``MultimodalEmotionModel.apply(train=True)`` draws, in
    the order it draws them, read through a ``Dropout`` interceptor that
    draws the module's key itself and hands it to the module."""
    seen = []

    def record(next_fun, args, kwargs, context):
        mod = context.module
        if (isinstance(mod, nn.Dropout) and context.method_name == "__call__"
                and mod.rate > 0 and not kwargs.get("deterministic", True)):
            rng = mod.make_rng("dropout")
            seen.append(("/".join(mod.scope.path), np.asarray(jax.random.bernoulli(
                rng, 1.0 - mod.rate, args[0].shape))))
            kwargs = dict(kwargs, rng=rng)
        return next_fun(*args, **kwargs)

    model = JaxFusion(cfg)
    params = model.init(jax.random.PRNGKey(0), video, audio, mask)
    with nn.intercept_methods(record):
        model.apply(params, video, audio, mask, train=True,
                    rngs={"dropout": step_key})
    return seen


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_the_eleven_flax_dropout_masks_bit_equal(dtype):
    """One training forward of the default-depth model (two fusion layers,
    11 sites): each site's module path and mask equal the port's draw of it
    (``dropout_draws`` under the step key, the step folded in by the plan),
    in flax's order."""
    kw = dict(NARROW, compute_dtype=dtype)
    rng = np.random.default_rng(0)
    video = jnp.asarray(rng.normal(size=(8, 3, 768)).astype(np.float32))
    audio = jnp.asarray(rng.normal(size=(8, 1024)).astype(np.float32))
    mask = jnp.asarray(np.arange(3)[None, :] >= rng.integers(1, 4, (8, 1)))
    step_key = jax.random.fold_in(jax.random.PRNGKey(11), 37)
    want = _flax_masks(jax_config.ModelConfig(**kw), video, audio, mask, step_key)
    cfg = port_config.ModelConfig(**kw)
    sites = _dropout_sites(cfg, 8, 3)
    got = prng.DrawPlan(dropout_draws(cfg, 8, 3), CPU).draw(
        [prng.PRNGKey(11)], step=37)
    assert len(want) == len(sites) == len(got) == 11
    for (path, m), site, ours in zip(want, sites, got):
        assert path == "/".join(site.path)
        assert ours.dtype == site.dtype
        np.testing.assert_array_equal(ours.float().numpy() > 0, m, err_msg=path)


# -- the key schedules -----------------------------------------------------------------

def test_key_schedules_follow_the_jax_trainers():
    """Epoch permutations, λ and step draws of the three schedules against
    the JAX trainers' own derivations (``mmer_tpu/train/loop.py:163-204``,
    ``train/fused.py:114-154``, ``train/streaming.py:39-52``): two epochs of
    3 steps over 70 rows at batch 32, seeds 4 and 5 as the fused lanes;
    ``state()`` is JAX's ``TrainState.rng`` and ``step``."""
    cfg = port_config.ModelConfig(**NARROW)
    tcfg = port_config.TrainConfig(mixup_alpha=0.4, modality_dropout=0.3)
    n, b, steps = 70, 32, 3
    first, last = dropout_draws(cfg, b, 3)[0], dropout_draws(cfg, b, 3)[-1]

    def site_mask(site, key):
        return np.asarray(jax.random.bernoulli(
            jax.random.fold_in(key, site.chain[0]), site.keep, site.shape))

    loop = port_keys.KeySchedule([4], "loop", cfg, tcfg, b, 3, CPU)
    fused = port_keys.KeySchedule([4, 5], "fused", cfg, tcfg, b, 3, CPU, lanes=True)
    rng_l = jax.random.split(jax.random.PRNGKey(4))[0]
    rng_f = [jax.random.split(jax.random.PRNGKey(s))[0] for s in (4, 5)]
    gstep = 0
    for _ in range(2):
        rng_l, shuffle = jax.random.split(rng_l)
        perm, lams = loop.begin_epoch(n, steps)
        assert lams is None             # the epoch loop has no opt-in
        np.testing.assert_array_equal(perm.numpy(), np.asarray(
            jax.random.permutation(shuffle, n)))
        fperm, flams = fused.begin_epoch(n, steps)
        epoch_keys = []
        for lane in range(2):
            rng_f[lane], sk, ek = jax.random.split(rng_f[lane], 3)
            epoch_keys.append(ek)
            np.testing.assert_array_equal(fperm[lane].numpy(), np.asarray(
                jax.random.permutation(sk, n)))
            np.testing.assert_array_equal(flams[lane].numpy(), np.asarray(
                [jax.random.beta(jax.random.fold_in(jax.random.fold_in(ek, i), 101),
                                 0.4, 0.4) for i in range(steps)]))
        for i in range(steps):
            np.testing.assert_array_equal(
                loop.draw().masks[0].numpy() > 0,
                site_mask(first, jax.random.fold_in(rng_l, gstep)))
            rand = fused.draw()
            for lane, ek in enumerate(epoch_keys):
                key = jax.random.fold_in(ek, i)
                np.testing.assert_array_equal(rand.masks[-1][lane].numpy() > 0,
                                              site_mask(last, key))
                np.testing.assert_array_equal(rand.u[lane].numpy(), np.asarray(
                    jax.random.uniform(jax.random.fold_in(key, 103), (b,))))
                np.testing.assert_array_equal(rand.j[lane].numpy(), np.asarray(
                    jax.random.permutation(jax.random.fold_in(key, 102), b)))
            gstep += 1
        assert _words(rng_l) == tuple(loop.state()["rng"][0].tolist())
        assert loop.state()["step"] == gstep
    stream = port_keys.KeySchedule([4], "streaming", cfg, tcfg, b, 3, CPU)
    for step in range(3):
        np.testing.assert_array_equal(
            stream.draw().masks[-1].numpy() > 0,
            site_mask(last, jax.random.fold_in(jax.random.PRNGKey(4), step)))
    with pytest.raises(ValueError, match="no epochs"):
        stream.begin_epoch(n, steps)


def test_an_old_layout_checkpoint_is_refused(tmp_path):
    """A mid-run checkpoint with torch generator states (the layout before
    the trainer drew JAX's keys) is refused with a message naming the
    change."""
    port_ckpt.save_loop_checkpoint(str(tmp_path), 2, {
        "model": {}, "shuffle_rng": torch.zeros(5, dtype=torch.uint8),
        "dropout_rng": torch.zeros(5, dtype=torch.uint8)},
        {"sched_bad": 0, "best_epoch": 0, "no_improve": 0, "has_best": False})
    with pytest.raises(ValueError, match="older checkpoint layout.*JAX's"):
        port_ckpt.restore_loop_checkpoint(str(tmp_path / "state_000002.pth"))


def test_draw_plan_lanes_and_index():
    """A plan's lanes are each lane's solo draws; an index plan draws at any
    flat indices; what a plan does not take is refused."""
    cfg = port_config.ModelConfig(**NARROW)
    draws = dropout_draws(cfg, 4, 3) + prng.permutation_draws((102,), 4)
    keys = [(1, 2), (3, 4), (5, 6)]
    many = prng.DrawPlan(draws, CPU, lanes=3).draw(keys, step=9)
    for lane, key in enumerate(keys):
        solo = prng.DrawPlan(draws, CPU).draw([key], step=9)
        for m, s in zip(many, solo):
            assert torch.equal(m[lane], s)
    idx = torch.tensor([0, 5, 2 ** 33 + 1], dtype=torch.int64)
    plan = prng.DrawPlan([prng.Draw((), (3,), "bits")], CPU, index=idx)
    assert torch.equal(plan.draw([(7, 8)])[0], prng.random_bits((7, 8), idx))
    with pytest.raises(ValueError, match="lanes"):
        prng.DrawPlan(draws, CPU, lanes=prng.MAX_LANES + 1)
    with pytest.raises(ValueError, match="fold-in words"):
        prng.DrawPlan([prng.Draw((1,) * 9, (2,), "bits")], CPU)
    with pytest.raises(ValueError, match="keys"):
        prng.DrawPlan(draws, CPU, lanes=3).draw(keys[:2])



# -- the kernel's work list -------------------------------------------------------------

def _step_draws(b, t=5):
    """A training step's draws at ModelConfig() width and batch ``b``."""
    return (dropout_draws(port_config.ModelConfig(), b, t)
            + [prng.Draw((103,), (b,), "uniform")]
            + prng.permutation_draws((102,), b))


@pytest.mark.parametrize("case", ["step64", "step256", "lanes4", "permutation",
                                  "index"])
def test_work_list_covers_every_segment_once(case):
    """``DrawPlan``'s work list at the training phase's plans: every element
    of every segment in exactly one range, ranges in segment order, none
    crossing a segment or longer than ``ITEM``, and every range but a
    segment's first starting where the output is aligned for the kernel's
    four-word stores (the first ends there, or at the segment's end)."""
    n = 6796
    plans = {
        "step64": lambda: prng.DrawPlan(_step_draws(64), CPU),
        "step256": lambda: prng.DrawPlan(_step_draws(256), CPU),
        "lanes4": lambda: prng.DrawPlan(_step_draws(64), CPU, lanes=4),
        "permutation": lambda: prng.DrawPlan(prng.permutation_draws((1,), n), CPU),
        "index": lambda: prng.DrawPlan([prng.Draw((), (n,), "bits")], CPU,
                                       index=torch.arange(n, dtype=torch.int64) * 3)}
    plan = plans[case]()
    table, work = plan.table.numpy(), plan.work.numpy()
    begin, seg, count = work[:, 0], work[:, 1] & 0xFFFFFFFF, work[:, 1] >> 32
    assert (np.diff(seg) >= 0).all() and (count >= 1).all()
    assert (count <= prng.ITEM).all() and count.sum() == plan.total
    for s, (lane, total, _, off, kind) in enumerate(table[:, :5]):
        mine = seg == s
        b, c = begin[mine], count[mine]
        assert b[0] == 0 and (b[1:] == (b + c)[:-1]).all() and (b + c)[-1] == total
        elt = 2 if kind == prng.KINDS["mask_bf16"] else 4
        aligned = (off // elt + b) % prng.VEC == 0
        assert aligned[1:].all()
        assert aligned[0] or c[0] < prng.VEC and (len(b) == 1 or aligned[1])


def _emulate(plan, keys, step):
    """The kernel's writes, range by range from the work list, in numpy:
    each range's bits at its counters, transformed as its segment's kind
    says, stored at the segment's byte offset."""
    out = np.zeros(plan.nbytes, np.uint8)
    table = plan.table.numpy()
    for begin, packed in plan.work.numpy():
        lane, _, _, off, kind, keep, index, chain_len = table[packed & 0xFFFFFFFF, :8]
        key = keys[lane] if step is None else prng.fold_in(keys[lane], step)
        for w in table[packed & 0xFFFFFFFF, 8:8 + chain_len]:
            key = prng.fold_in(key, int(w))
        i = torch.arange(begin, begin + (packed >> 32))
        bits = prng.random_bits_plain(key, plan.index[i] if index else i).numpy()
        bits = bits.astype(np.uint32)
        u = ((bits >> 9) | 0x3F800000).view(np.float32) - np.float32(1)
        keep = np.array(keep, np.uint32).view(np.float32)
        value = {0: bits, 1: bits ^ 0x80000000, 2: u.view(np.uint32),
                 3: (u < keep).astype(np.float32).view(np.uint32),
                 4: (u < keep).astype(np.float32).view(np.uint32) >> 16}[kind]
        data = value.astype(np.uint16 if kind == 4 else np.uint32).view(np.uint8)
        start = off + begin * (2 if kind == 4 else 4)
        out[start:start + data.size] = data
    return plan._views(torch.from_numpy(out))


def test_work_list_ranges_write_the_plain_draws():
    """Written range by range as the kernel writes them, the work list's
    ranges give ``draw_plain``'s draws, bit for bit: three lanes of a narrow
    step with draws of odd sizes (so lanes start unaligned: a bfloat16 mask
    of 15, a uniform of 5, sort keys of 7) and one of more than ``ITEM``,
    and an index plan with high counter words."""
    cfg = port_config.ModelConfig(**NARROW)
    draws = (dropout_draws(cfg, 3, 3)
             + [prng.Draw((103,), (5,), "uniform"),
                prng.Draw((77,), (3, 5), "mask", 0.9, torch.bfloat16),
                prng.Draw((78, 5), (1029,), "mask", 0.5, torch.float32)]
             + prng.permutation_draws((102,), 7))
    keys = [(1, 2), (3, 4), (5, 6)]
    plan = prng.DrawPlan(draws, CPU, lanes=3)
    assert (plan.work.numpy()[:, 1] >> 32 < prng.VEC).sum() >= 4     # heads
    for got, want in zip(_emulate(plan, keys, 9), plan.draw_plain(keys, 9)):
        assert got.dtype == want.dtype and torch.equal(got, want)
    idx = torch.arange(2 ** 32 - 700, 2 ** 32 + 1300, 3, dtype=torch.int64)
    plan = prng.DrawPlan([prng.Draw((), (idx.numel(),), "bits")], CPU, index=idx)
    assert torch.equal(_emulate(plan, [(7, 8)], None)[0],
                       plan.draw_plain([(7, 8)])[0])


# -- the committed fixture of JAX's draws ----------------------------------------------

def test_committed_fixture_matches_the_plain_draws():
    """The fixture the card is held to equals this CPU's plain draws of the
    same cases (so a card that matches the fixture matches JAX)."""
    fx = np.load(port_keys.DRAWS_FIXTURE)
    meta = json.loads(str(fx["meta"]))
    assert meta["jax"] == jax.__version__ and meta["flax"] == flax.__version__
    for name, (got, want) in port_keys.fixture_draws(CPU, fx).items():
        np.testing.assert_array_equal(got, want, err_msg=name)


def write_fixture(path: str = port_keys.DRAWS_FIXTURE) -> None:
    """Write ``mmer_tpu_torch/assets/jax_draws.npz``: JAX's own draws of the
    cases ``train/keys.py:FIXTURE_CASES`` names, at ``ModelConfig()`` width
    (T = 5 video tokens): the epoch permutations over 6,796 rows, the 11
    flax masks of chosen steps (``sample_indices(size, SAMPLES)`` of each),
    ``u`` and ``j`` of the fused schedule, an epoch of ``λ`` at α = 0.4 as
    the fused step draws it, and 32-bit bits."""
    out = {}
    rng = np.random.default_rng(0)
    t = port_keys.FIXTURE_T
    video = jnp.asarray(rng.normal(size=(256, t, 768)).astype(np.float32))
    audio = jnp.asarray(rng.normal(size=(256, 1024)).astype(np.float32))
    pad = jnp.zeros((256, t), bool)
    cfg = jax_config.ModelConfig()
    for name, case in port_keys.FIXTURE_CASES.items():
        seeds, b, n = case["seeds"], case["batch"], port_keys.FIXTURE_ROWS
        for lane, seed in enumerate(seeds):
            rng_key = jax.random.split(jax.random.PRNGKey(seed))[0]
            gstep = 0
            for epoch in range(case["epochs"]):
                if case["schedule"] == "loop":
                    rng_key, shuffle = jax.random.split(rng_key)
                    base = rng_key
                else:
                    rng_key, shuffle, base = jax.random.split(rng_key, 3)
                tag = f"{name}/{lane}/e{epoch}"
                out[f"{tag}/perm"] = np.asarray(
                    jax.random.permutation(shuffle, n), np.int16)
                steps = -(-n // b)
                for i in range(steps):
                    step = gstep if case["schedule"] == "loop" else i
                    if i in case["steps"]:
                        key = jax.random.fold_in(base, step)
                        masks = _flax_masks(cfg, video[:b], audio[:b], pad[:b], key)
                        for k, (_, m) in enumerate(masks):
                            idx = port_keys.sample_mask(m.size)
                            out[f"{tag}/s{i}/mask{k}"] = np.ravel(m)[idx]
                        if case["schedule"] == "fused":
                            out[f"{tag}/s{i}/u"] = np.asarray(jax.random.uniform(
                                jax.random.fold_in(key, 103), (b,)))
                            out[f"{tag}/s{i}/j"] = np.asarray(jax.random.permutation(
                                jax.random.fold_in(key, 102), b), np.int16)
                    gstep += 1
                if case.get("alpha"):
                    alpha = case["alpha"]
                    out[f"{tag}/lam"] = np.asarray(jax.jit(lambda ek: jax.lax.scan(
                        lambda c, i: (c, jax.random.beta(jax.random.fold_in(
                            jax.random.fold_in(ek, i), 101), alpha, alpha)),
                        0, jnp.arange(steps))[1])(base))
    key = jax.random.PRNGKey(port_keys.FIXTURE_BITS_SEED)
    bits = np.asarray(jax.random.bits(key, (port_keys.FIXTURE_BITS,)), np.uint32)
    out["bits"] = bits[port_keys.sample_mask(bits.size)]
    out["meta"] = np.array(json.dumps({"jax": jax.__version__,
                                       "flax": flax.__version__,
                                       "cases": port_keys.FIXTURE_CASES}))
    np.savez_compressed(path, **out)
    with open(path, "rb") as f:
        print(f"wrote {path}: {os.path.getsize(path)} bytes, sha1 "
              f"{hashlib.sha1(f.read()).hexdigest()}")


if __name__ == "__main__":
    if sys.argv[1:] != ["--write"]:
        sys.exit("usage: JAX_PLATFORMS=cpu python tests/test_torch_prng.py --write")
    write_fixture()
