"""The PyTorch port's training side beyond the plain trainer, against the JAX
package on the CPU: the trainer's opt-ins (EMA, mixup, modality dropout,
distillation), seed-batched training, distillation's teacher targets,
ensembles, flax ``.msgpack`` checkpoints, test-set IG, the CLI's new flags and
the flagship / seed-sweep scripts.

The port draws JAX's own random stream (``train/keys.py``), so every run
here is held to the JAX run of the same seed directly, at the default
dropout 0.1, with nothing injected: the fused trainer's shuffles, masks,
``u``, ``λ`` and ``j`` (``mmer_tpu/train/fused.py:114-154``).  The batched
trainer is also held to the port's own solo runs.
"""

from __future__ import annotations

import glob
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import flax.serialization as flax_ser
import mmer_tpu.config as jax_config
import mmer_tpu.train.checkpoint as jax_ckpt
import mmer_tpu.train.distill as jax_distill
import mmer_tpu.train.ensemble as jax_ensemble
import mmer_tpu.train.fused as jax_fused
import mmer_tpu.train.loop as jax_loop
from mmer_tpu.models.fusion import MultimodalEmotionModel as JaxFusion
import mmer_tpu_torch.config as port_config
import mmer_tpu_torch.serve.app as port_app
import mmer_tpu_torch.train.distill as port_distill
import mmer_tpu_torch.train.ensemble as port_ensemble
import mmer_tpu_torch.train.fused as port_fused
import mmer_tpu_torch.train.loop as port_loop
from mmer_tpu_torch.core import msgpack as port_msgpack
from mmer_tpu_torch.models.convert import fusion_from_flax, fusion_to_flax
from mmer_tpu_torch.serve.engine import InferenceEngine
from mmer_tpu_torch.train import checkpoint as port_ckpt
from tests.conftest import make_tiny_dataset
from tests.test_torch_train import assert_weights_match
from torch_threads import few_threads  # noqa: F401

CPU = torch.device("cpu")
TRAIN_KW = dict(max_seq_len=4, fusion_layers=1, fusion_heads=2, fused_dim=32,
                fusion_ffn_dim=64, classifier_hidden_dim=32,
                compute_dtype="float32", fusion_dropout=0.0,
                classifier_dropout=0.0)
BATCH = 32


def _np_tree(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _soft_targets(n, seed=5):
    rng = np.random.default_rng(seed)
    return rng.dirichlet(np.ones(6), size=n).astype(np.float32)


# The opt-ins' runs at the default dropout.
OPT_KW = dict(TRAIN_KW, fusion_dropout=0.1, classifier_dropout=0.1)
# All four together run at dropout 0: at 0.1, one element of video_proj's
# kernel has a clipped gradient that cancels its L2 term to 1e-9 at the first
# step (2.81e-6 against -2.81e-6), where Adam's first step follows the float
# noise's sign; the two runs part there by 1e-3, and their validation losses
# by 1.5e-4 in the second epoch (measured on this CPU).
# At dropout 0 too, Adam's steps on elements near 0 leave their final
# weights 1.2e-4 apart (relative L2, norm_video's bias; measured): held at
# 3e-4 there, 1e-4 elsewhere.
ALL_FOUR_KW = TRAIN_KW


def _assert_rows_match(got_rows, want_rows, loss_rtol=1e-4):
    assert len(got_rows) == len(want_rows)                 # the stop epoch
    for g, w in zip(got_rows, want_rows):
        for key in w:
            if key == "learning_rate" and key not in g:
                continue
            if key.endswith("_loss"):
                np.testing.assert_allclose(g[key], w[key], rtol=loss_rtol,
                                           err_msg=key)
            else:       # from equal confusion matrices, or the lr
                np.testing.assert_allclose(g[key], w[key], rtol=1e-6,
                                           err_msg=key)


OPT_IN_CASES = {
    "ema": dict(ema_decay=0.9),
    "mixup": dict(mixup_alpha=0.4),
    "modality_dropout": dict(modality_dropout=0.5),
    "distill": dict(distill_alpha=0.5, distill_temp=2.0),
    "all_four": dict(ema_decay=0.8, mixup_alpha=0.4, modality_dropout=0.3,
                     distill_alpha=0.5, distill_temp=1.0, label_smoothing=0.1),
}


@pytest.mark.parametrize("case", list(OPT_IN_CASES))
def test_train_model_opt_ins_match_jax_fused(monkeypatch, case):
    """``train_model(fused=True)`` with each opt-in alone and all four
    together against ``mmer_tpu.train.loop.train_model(fused=True)`` of the
    same seed at dropout 0.1 (all four at 0, :data:`ALL_FOUR_KW`), each side
    drawing its own stream: per-epoch
    losses within 1e-4 relative, equal confusion matrices (so equal derived
    metrics), the learning rates, best epoch, early-stop epoch, and the final
    and best parameters within 1e-4 (``assert_weights_match``)."""
    data, splits = make_tiny_dataset(seed=0, n=200, t=3, separable=True)
    extra = OPT_IN_CASES[case]
    train_kw = dict(num_epochs=7, lr=3e-3, save_checkpoints=False, patience=2,
                    min_delta=0.02, scheduler_patience=0, scheduler_factor=0.5,
                    **extra)
    soft = _soft_targets(len(data.labels)) if "distill_alpha" in extra else None
    model_kw = ALL_FOUR_KW if case == "all_four" else OPT_KW
    want = jax_loop.train_model(
        data, splits, jax_config.ModelConfig(**model_kw),
        jax_config.TrainConfig(**train_kw), batch_size=BATCH, seed=0,
        verbose=False, fused=True, soft_targets=soft)
    tcfg = port_config.TrainConfig(**train_kw)
    lrs = []
    real_step = port_loop.PlateauScheduler.step
    monkeypatch.setattr(port_loop.PlateauScheduler, "step",
                        lambda self, v, lr: lrs.append(real_step(self, v, lr))
                        or lrs[-1])
    got = port_loop.train_model(
        data, splits, port_config.ModelConfig(**model_kw), tcfg,
        batch_size=BATCH, seed=0, verbose=False, device="cpu",
        soft_targets=soft, fused=True)

    # The run exercises what it claims to: an lr cut, an early stop, and
    # (with EMA) a best model that is not the raw trajectory.
    assert min(r["learning_rate"] for r in want.results) < train_kw["lr"]
    assert 3 <= len(want.results) < train_kw["num_epochs"]
    _assert_rows_match(got.results, want.results)
    np.testing.assert_allclose(lrs, [r["learning_rate"] for r in want.results],
                               rtol=1e-6)
    assert got.best_epoch == want.best_epoch
    np.testing.assert_array_equal(got.confusion, want.confusion)
    np.testing.assert_allclose(got.best_score, want.best_score, rtol=1e-4)
    assert ("ema_decay" in got.hyperparameters) == ("ema_decay" in extra)
    for ours, theirs in ((got.final_params, want.final_params),
                         (got.best_params, want.best_params)):
        assert_weights_match(ours, fusion_from_flax(_np_tree(theirs)),
                             rel=3e-4 if case == "all_four" else 1e-4)
    if "ema_decay" in extra:
        assert any(not torch.equal(got.final_params[k], got.best_params[k])
                   for k in got.final_params)
    if "mixup_alpha" in extra:
        assert len(got.lambda_ms) == len(got.results)


# -- seed-batched training ------------------------------------------------------------

MANY_KW = dict(num_epochs=7, lr=3e-3, save_checkpoints=False, patience=2,
               min_delta=0.02, scheduler_patience=0, scheduler_factor=0.5,
               mixup_alpha=0.4, modality_dropout=0.3, ema_decay=0.8)


def test_train_many_seeds_matches_jax_per_seed():
    """S = 3 seeds in one batched call against JAX's ``train_many_seeds`` at
    dropout 0.1, each drawing its own stream: per seed the rows (losses
    within 1e-4 relative, equal confusion matrices, the learning rates),
    best epoch, stop epoch, best score and best parameters.  One seed stops
    early and stays frozen while the others go on."""
    data, splits = make_tiny_dataset(seed=0, n=200, t=3, separable=True)
    seeds = [0, 1, 2]
    want = jax_fused.train_many_seeds(
        data, splits, jax_config.ModelConfig(**OPT_KW),
        jax_config.TrainConfig(**MANY_KW), batch_size=BATCH, seeds=seeds,
        seeds_per_call=3, verbose=False)
    got = port_fused.train_many_seeds(
        data, splits, port_config.ModelConfig(**OPT_KW),
        port_config.TrainConfig(**MANY_KW), batch_size=BATCH, seeds=seeds,
        seeds_per_call=3, verbose=False, device="cpu")

    lengths = [len(w["results"]) for w in want]
    assert min(lengths) < max(lengths)          # a seed stopped early
    for g, w in zip(got, want):
        assert g["seed"] == w["seed"] and g["best_epoch"] == w["best_epoch"]
        assert set(g) == set(w)
        _assert_rows_match(g["results"], w["results"])
        assert g["results"][0].keys() == w["results"][0].keys()
        np.testing.assert_allclose(g["best_score"], w["best_score"], rtol=1e-4)
        assert_weights_match(g["best_params"],
                             fusion_from_flax(_np_tree(w["best_params"])))


def test_train_many_seeds_equals_solo_runs_with_dropout():
    """Dropout 0.2 (drawn ahead of the vmapped forward, one lane a seed) and
    every opt-in on: seed s of a batched call is ``train_model(seed=s,
    fused=True)``.  A stacked GEMM sums in another order: measured
    on the CPU, losses 1e-7 relative apart and parameters 6.5e-5 absolute at
    worst (one element of 32,768, where Adam normalises a gradient near 0);
    held at 1e-5 and 2e-4.  The seeds stop at different epochs."""
    data, splits = make_tiny_dataset(seed=0, n=200, t=3, separable=True)
    kw = dict(TRAIN_KW, fusion_dropout=0.2, classifier_dropout=0.2)
    cfg = port_config.ModelConfig(**kw)
    tcfg = port_config.TrainConfig(**MANY_KW, distill_alpha=0.5)
    soft = _soft_targets(len(data.labels))
    got = port_fused.train_many_seeds(data, splits, cfg, tcfg, batch_size=BATCH,
                                      seeds=[0, 1, 2], seeds_per_call=3,
                                      verbose=False, device="cpu",
                                      soft_targets=soft)
    lengths = set()
    for g in got:
        solo = port_loop.train_model(data, splits, cfg, tcfg, batch_size=BATCH,
                                     seed=g["seed"], verbose=False,
                                     device="cpu", soft_targets=soft,
                                     fused=True)
        lengths.add(len(solo.results))
        assert g["best_epoch"] == solo.best_epoch
        assert len(g["results"]) == len(solo.results)
        for gr, sr in zip(g["results"], solo.results):
            assert set(gr) - set(sr) == {"learning_rate"}
            for key in sr:
                np.testing.assert_allclose(
                    gr[key], sr[key], rtol=1e-5 if key.endswith("_loss") else 1e-12,
                    err_msg=key)
        for name, value in solo.best_params.items():
            np.testing.assert_allclose(g["best_params"][name].numpy(),
                                       value.numpy(), rtol=1e-4, atol=2e-4,
                                       err_msg=name)
    assert len(lengths) > 1


def test_masks_drawn_ahead_equal_the_forwards_own():
    """The masks a step draws ahead of its forward in one plan
    (``dropout_draws``) are, site by site, flax's: ``bernoulli`` under the
    step key folded with the site's path and counter, at two layers, with
    different fusion and classifier rates, in the order the forward applies
    them; and the forward applies them as flax does."""
    from flax.core import scope as flax_scope
    from mmer_tpu_torch.models.fusion import (DropoutMasks, _dropout_sites,
                                              dropout_draws, dropout_scales,
                                              init_fusion)
    from mmer_tpu_torch.ops import prng

    kw = dict(TRAIN_KW, fusion_layers=2, fusion_dropout=0.2,
              classifier_dropout=0.3)
    cfg = port_config.ModelConfig(**kw)
    sites = _dropout_sites(cfg, 8, 3)
    assert len(sites) == 1 + 4 * 2 + 2
    step_key = jax.random.fold_in(jax.random.PRNGKey(5), 7)
    masks = prng.DrawPlan(dropout_draws(cfg, 8, 3), CPU).draw(
        [prng.PRNGKey(5)], step=7)
    for site, mask in zip(sites, masks):
        key = flax_scope._fold_in_static(step_key, site.path + (1,))
        want = jax.random.bernoulli(key, 1.0 - site.rate, site.shape)
        np.testing.assert_array_equal(mask.numpy() > 0, np.asarray(want),
                                      err_msg="/".join(site.path))
    data, _ = make_tiny_dataset(seed=4, n=150, t=3)
    model = init_fusion(cfg, device=CPU, seed=0)
    model.train()
    args = [torch.from_numpy(a[:8]) for a in (data.video, data.audio,
                                              data.pad_mask)]
    got = model(*args, masks=DropoutMasks(masks, dropout_scales(cfg, CPU)))[1]
    params = fusion_to_flax(model.state_dict(), cfg.fusion_heads)
    want = JaxFusion(jax_config.ModelConfig(**kw)).apply(
        {"params": params}, *[jnp.asarray(a.numpy()) for a in args],
        train=True, rngs={"dropout": step_key})[1]
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               rtol=1e-5, atol=1e-6)


def test_stacked_adam_equals_torch_adam_per_seed():
    """The batched clip and optimiser against ``clip_by_global_norm`` and one
    ``torch.optim.Adam`` (L2 into the gradient) a seed, bit for bit, over
    steps on both sides of the clip, with each seed its own lr and a seed
    that stops taking steps half way."""
    rng = np.random.default_rng(3)
    shapes = [(7, 5), (5,), (3, 4, 2)]
    s_count, wd = 3, 1e-2
    init = [rng.normal(size=(s_count,) + sh).astype(np.float32) for sh in shapes]
    stacked = [torch.tensor(a) for a in init]
    opt = port_fused.StackedAdam(stacked, wd)
    solo = [[torch.nn.Parameter(torch.tensor(a[s])) for a in init]
            for s in range(s_count)]
    solo_opt = [torch.optim.Adam(ps, lr=1e-2, betas=(0.9, 0.999), eps=1e-8,
                                 weight_decay=wd) for ps in solo]
    lrs = [1e-2, 3e-3, 5e-3]
    for step, scale in enumerate((3.0, 0.01, 1.0, 0.1, 2.0)):
        active = np.array([True, True, step < 2])
        raw = [(rng.normal(size=(s_count,) + sh) * scale).astype(np.float32)
               for sh in shapes]
        grads = [torch.tensor(r) for r in raw]
        norms = port_fused.clip_stacked(grads, 1.0)
        opt.step(grads, lrs, active)
        for s in np.flatnonzero(active):
            for p, r in zip(solo[s], raw):
                p.grad = torch.tensor(r[s])
            norm = port_loop.clip_by_global_norm(solo[s], 1.0)
            assert torch.equal(norm, norms[s])
            for p, g in zip(solo[s], grads):
                assert torch.equal(p.grad, g[s])
            port_loop.set_learning_rate(solo_opt[s], lrs[s])
            solo_opt[s].step()
    for s in range(s_count):
        for p, q in zip(solo[s], stacked):
            assert torch.equal(q[s], p.detach())
    assert list(opt.steps) == [5, 5, 2]


def test_the_opt_ins_refuse_what_jax_refuses():
    data, splits = make_tiny_dataset(seed=0, n=96, t=3)
    cfg = port_config.ModelConfig(**TRAIN_KW)
    soft = _soft_targets(96)

    def run(tcfg, fn=port_loop.train_model, model_cfg=cfg, **kw):
        if fn is port_loop.train_model:
            return fn(data, splits, model_cfg, tcfg, verbose=False,
                      device="cpu", fused=kw.pop("fused", True), **kw)
        return fn(data, splits, model_cfg, tcfg, batch_size=BATCH, seeds=[0],
                  verbose=False, device="cpu", **kw)

    for fn in (port_loop.train_model, port_fused.train_many_seeds):
        with pytest.raises(ValueError, match="exactly when distill_alpha"):
            run(port_config.TrainConfig(num_epochs=1), fn, soft_targets=soft)
        with pytest.raises(ValueError, match="exactly when distill_alpha"):
            run(port_config.TrainConfig(distill_alpha=0.5), fn)
        with pytest.raises(ValueError, match="soft_targets rows 95"):
            run(port_config.TrainConfig(distill_alpha=0.5), fn,
                soft_targets=soft[:95])
        with pytest.raises(ValueError, match="batchnorm"):
            run(port_config.TrainConfig(ema_decay=0.9), fn,
                model_cfg=port_config.ModelConfig(**TRAIN_KW, norm="batchnorm"))
    # The fused schedule takes no mid-run checkpoints; the epoch loop's has
    # no opt-in (JAX's rules, mmer_tpu/train/loop.py:343-349, :476-486).
    with pytest.raises(ValueError, match="checkpoint_every"):
        run(port_config.TrainConfig(modality_dropout=0.2, checkpoint_every=2))
    with pytest.raises(ValueError, match="modality_dropout: implemented in "
                                         "the fused trainer only"):
        run(port_config.TrainConfig(modality_dropout=0.2), fused=False)
    # The batched trainer refuses batchnorm with no opt-in as well.
    with pytest.raises(ValueError, match="batchnorm"):
        run(port_config.TrainConfig(num_epochs=1), port_fused.train_many_seeds,
            model_cfg=port_config.ModelConfig(**TRAIN_KW, norm="batchnorm"))
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            port_fused.train_many_seeds(data, splits, cfg,
                                        port_config.TrainConfig(), 32, [0])


# -- distillation's teacher and the ensembles --------------------------------------

@pytest.fixture(scope="module")
def members():
    """Three JAX fusion param trees (perturbed inits, so the members
    disagree) and the same weights as port state dicts."""
    data, splits = make_tiny_dataset(seed=3, n=150, t=3, separable=True)
    model = JaxFusion(jax_config.ModelConfig(**TRAIN_KW))
    trees, states = [], []
    for seed in range(3):
        p = _np_tree(model.init(jax.random.PRNGKey(seed),
                                jnp.asarray(data.video[:2]),
                                jnp.asarray(data.audio[:2]),
                                jnp.asarray(data.pad_mask[:2]))["params"])
        rng = np.random.default_rng(seed)
        p = jax.tree_util.tree_map(
            lambda a: a + 0.1 * rng.normal(size=a.shape).astype(np.float32), p)
        trees.append(p)
        states.append(fusion_from_flax(p))
    return data, splits, trees, states


def test_teacher_soft_targets_match_jax(members):
    """150 rows at batch 64 (a ragged tail): within 1e-6, rows summing to 1."""
    data, _, trees, states = members
    cfg_j = jax_config.ModelConfig(**TRAIN_KW)
    want = jax_distill.teacher_soft_targets(cfg_j, trees, data, batch=64)
    got = port_distill.teacher_soft_targets(
        port_config.ModelConfig(**TRAIN_KW), states, data, batch=64,
        device="cpu")
    assert got.shape == want.shape == (150, 6) and got.dtype == np.float32
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)
    np.testing.assert_allclose(got.sum(1), 1.0, atol=1e-5)
    with pytest.raises(ValueError, match="at least one"):
        port_distill.teacher_soft_targets(port_config.ModelConfig(**TRAIN_KW),
                                          [], data, device="cpu")


def test_ensembles_match_jax(members):
    """``member_probs`` within 1e-6; ``ensemble_eval`` and
    ``greedy_ensemble_eval`` (with and without replacement) equal; the numpy
    ``greedy_select`` equal to the original on a random pool; ``soup_params``
    within two float32 ulps of JAX's soup, converted (a mean of three sums
    in another order)."""
    data, splits, trees, states = members
    cfg_j = jax_config.ModelConfig(**TRAIN_KW)
    cfg_p = port_config.ModelConfig(**TRAIN_KW)
    for split in ("val", "test"):
        np.testing.assert_allclose(
            port_ensemble.member_probs(cfg_p, states, data, splits, split,
                                       device="cpu"),
            jax_ensemble.member_probs(cfg_j, trees, data, splits, split),
            rtol=0, atol=1e-6)
    got = port_ensemble.ensemble_eval(cfg_p, states, data, splits, "test",
                                      device="cpu")
    want = jax_ensemble.ensemble_eval(cfg_j, trees, data, splits, "test")
    assert got == pytest.approx(want, rel=1e-12)
    for replace in (False, True):
        assert port_ensemble.greedy_ensemble_eval(
            cfg_p, states, data, splits, k_max=3, replace=replace,
            device="cpu") == jax_ensemble.greedy_ensemble_eval(
            cfg_j, trees, data, splits, k_max=3, replace=replace)
    rng = np.random.default_rng(0)
    pool = rng.dirichlet(np.ones(6), size=(6, 80)).astype(np.float32)
    labels = rng.integers(0, 6, size=80)
    for replace in (False, True):
        assert port_ensemble.greedy_select(pool, labels, 5, replace) == \
            jax_ensemble.greedy_select(pool, labels, 5, replace)
    with pytest.raises(ValueError, match="k_max"):
        port_ensemble.greedy_select(pool, labels, 0)
    soup = port_ensemble.soup_params(states)
    for name, value in fusion_from_flax(_np_tree(
            jax_ensemble.soup_params(trees))).items():
        np.testing.assert_allclose(soup[name].numpy(), value.numpy(),
                                   rtol=2.5e-7, atol=1e-9, err_msg=name)
    with pytest.raises(ValueError, match="at least one"):
        port_ensemble.soup_params([])


# -- flax checkpoints ---------------------------------------------------------------

@pytest.mark.parametrize("width", ["tiny", "full"])
def test_flax_msgpack_round_trip(tmp_path, width):
    """A JAX-written fusion checkpoint (the tiny and the full-width tree,
    7.76 M parameters) decodes to leaves equal to flax's, in flax's order;
    the port writes it back, through ``fusion_to_flax``, byte for byte as
    the JAX package's ``save_params_msgpack`` does."""
    kw = TRAIN_KW if width == "tiny" else dict(max_seq_len=6)
    cfg = jax_config.ModelConfig(**kw)
    t = cfg.max_seq_len - 1
    params = JaxFusion(cfg).init(jax.random.PRNGKey(7), jnp.zeros((2, t, 768)),
                                 jnp.zeros((2, 1024)),
                                 jnp.zeros((2, t), bool))["params"]
    path = str(tmp_path / "jax.msgpack")
    jax_ckpt.save_params_msgpack(path, params)
    with open(path, "rb") as f:
        raw = f.read()
    got = port_ckpt.load_params_msgpack(path)
    want = flax_ser.msgpack_restore(raw)
    got_leaves = jax.tree_util.tree_leaves_with_path(got)
    want_leaves = jax.tree_util.tree_leaves_with_path(want)
    assert [p for p, _ in got_leaves] == [p for p, _ in want_leaves]
    for (_, g), (_, w) in zip(got_leaves, want_leaves):
        assert g.dtype == w.dtype and np.array_equal(g, w)
    sd = fusion_from_flax(got)
    ours = str(tmp_path / "port.msgpack")
    port_ckpt.save_params_msgpack(ours, fusion_to_flax(sd, cfg.fusion_heads))
    with open(ours, "rb") as f:
        assert f.read() == raw == flax_ser.to_bytes(jax.device_get(params))
    if width == "full":
        assert sum(v.numel() for v in sd.values()) == 7_759_878


def test_msgpack_refusals_and_batchnorm_tree(tmp_path):
    """Flax's chunked-array form and ext codes other than ndarray raise,
    naming the case; a batchnorm model's tree comes back as the JAX
    trainer's ``{"params", "batch_stats"}`` composite."""
    chunked = flax_ser.msgpack_serialize(
        {"w": {"__msgpack_chunked_array__": True, "shape": {"0": 2},
               "chunks": {"0": np.zeros(2, np.float32)}}})
    with pytest.raises(ValueError, match="chunked-array"):
        port_msgpack.unpackb(chunked)
    scalar = flax_ser.msgpack_serialize({"s": np.float32(1.0)})
    with pytest.raises(ValueError, match="ext code 3"):
        port_msgpack.unpackb(scalar)
    with pytest.raises(ValueError, match="trailing"):
        port_msgpack.unpackb(flax_ser.msgpack_serialize({"a": 1}) + b"\x00")
    with pytest.raises(TypeError, match="numpy scalar"):
        port_msgpack.packb({"s": np.float32(1.0)})
    kw = dict(TRAIN_KW, norm="batchnorm")
    variables = _np_tree(dict(JaxFusion(jax_config.ModelConfig(**kw)).init(
        jax.random.PRNGKey(1), jnp.zeros((2, 3, 768)), jnp.zeros((2, 1024)),
        jnp.zeros((2, 3), bool))))
    tree = fusion_to_flax(fusion_from_flax(variables), 2)
    assert set(tree) == {"params", "batch_stats"}
    assert port_msgpack.packb(tree) == flax_ser.to_bytes(
        jax.device_get({"params": variables["params"],
                        "batch_stats": variables["batch_stats"]}))


def test_engine_serves_flax_checkpoints_and_mixed_ensembles(members, tmp_path):
    """A flax-written ``.msgpack`` served by the port's engine within 1e-5
    of JAX's ``model.apply`` probabilities, alone and in an ensemble with a
    ``.pth``; ``resolve_default_fusion`` returns a ``.msgpack`` flagship."""
    data, _, trees, states = members
    cfg_p = port_config.ModelConfig(**TRAIN_KW)
    model = JaxFusion(jax_config.ModelConfig(**TRAIN_KW))
    a_path = str(tmp_path / "a.msgpack")
    jax_ckpt.save_params_msgpack(a_path, trees[0])
    b_path = str(tmp_path / "b.pth")
    port_ckpt.save_state_dict(b_path, states[1])
    v, a, m = data.video[:7], data.audio[:7], data.pad_mask[:7]
    want_a = np.asarray(model.apply({"params": trees[0]}, v, a, m)[0])
    want_b = np.asarray(model.apply({"params": trees[1]}, v, a, m)[0])
    one = InferenceEngine(CPU, model_cfg=cfg_p, fusion_params_path=a_path)
    np.testing.assert_allclose(one._fusion_probs(v, a, m), want_a, rtol=0,
                               atol=1e-5)
    both = InferenceEngine(CPU, model_cfg=cfg_p,
                           fusion_params_path=f"{a_path},{b_path}")
    assert both.fusion.members == 2
    np.testing.assert_allclose(both._fusion_probs(v, a, m),
                               (want_a + want_b) / 2, rtol=0, atol=1e-5)
    d = tmp_path / "flagship"
    d.mkdir()
    os.replace(a_path, d / "flagship.msgpack")
    np.savez(d / "norm_stats.npz", video_mean=np.zeros(2))
    (d / "manifest.json").write_text(json.dumps(
        {"checkpoint": "artifacts/flagship/flagship.msgpack",
         "model_config": {"max_seq_len": 4}}))
    assert port_app.resolve_default_fusion(str(d)) == (
        str(d / "flagship.msgpack"), str(d / "norm_stats.npz"),
        {"max_seq_len": 4})


# -- test-set IG ----------------------------------------------------------------------

def test_interpret_test_set_matches_jax(members, tmp_path):
    """The same three files with the same columns, labels and JSON keys;
    per-sample importances within IG's 1e-4 relative L2."""
    from mmer_tpu.interpret import interpret_test_set as jax_interpret
    from mmer_tpu_torch.interpret.ig import interpret_test_set
    from mmer_tpu_torch.models.fusion import MultimodalEmotionModel

    data, splits, trees, states = members
    model = JaxFusion(jax_config.ModelConfig(**TRAIN_KW))
    host = {"video": data.video, "audio": data.audio,
            "pad_mask": data.pad_mask, "labels": data.labels}
    jax_interpret(lambda p, v, a, m: model.apply({"params": p}, v, a, m)[1],
                  trees[0], host, splits.test, output_dir=str(tmp_path / "j"),
                  batch_size=8, n_steps=10, verbose=False, timestamp="t")
    pmodel = MultimodalEmotionModel(port_config.ModelConfig(**TRAIN_KW),
                                    device=CPU)
    pmodel.load_state_dict(states[0])
    out = interpret_test_set(lambda v, a, m: pmodel(v, a, m)[1], host,
                             splits.test, output_dir=str(tmp_path / "p"),
                             batch_size=8, n_steps=10, verbose=False,
                             timestamp="t", device="cpu")
    assert sorted(os.listdir(tmp_path / "p")) == sorted(
        os.listdir(tmp_path / "j")) == ["audio_importances_t.csv",
                                        "global_importances_t.json",
                                        "video_importances_t.csv"]
    for name in ("video_importances_t.csv", "audio_importances_t.csv"):
        got = np.genfromtxt(tmp_path / "p" / name, delimiter=",", names=True)
        want = np.genfromtxt(tmp_path / "j" / name, delimiter=",", names=True)
        assert got.dtype.names == want.dtype.names
        np.testing.assert_array_equal(got["label"], want["label"])
        cols = [c for c in want.dtype.names if c != "label"]
        g = np.stack([got[c] for c in cols], 1)
        w = np.stack([want[c] for c in cols], 1)
        assert np.linalg.norm(g - w) / np.linalg.norm(w) < 1e-4, name
    with open(tmp_path / "j" / "global_importances_t.json") as f:
        want = json.load(f)
    assert out.keys() == want.keys()
    for key in want:
        assert out[key].keys() == want[key].keys()


# -- the CLI and the scripts ---------------------------------------------------------

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def test_cli_new_flags(synthetic_feature_dirs, tmp_path, monkeypatch):
    """Every flag the port's CLI gained, in one run at full width: the
    opt-ins reach ``TrainConfig``, ``--distill_from`` blends a JAX-written
    ``.msgpack`` and a port ``.pth`` into the teacher targets
    ``teacher_soft_targets`` gives for them, ``--interpret`` writes the IG
    artifacts and ``--profile_dir`` a Chrome trace."""
    from mmer_tpu_torch.data.pipeline import load_dataset
    from mmer_tpu_torch.models.fusion import init_fusion
    from mmer_tpu_torch.train import cli as port_cli

    vdir, adir = synthetic_feature_dirs
    data, _ = load_dataset(port_config.DataConfig(video_feat_dir=vdir,
                                                  audio_feat_dir=adir))
    t = data.max_chunks
    cfg = port_config.ModelConfig(max_seq_len=t + 1)
    a_path = str(tmp_path / "a.msgpack")
    jax_ckpt.save_params_msgpack(a_path, JaxFusion(jax_config.ModelConfig(
        max_seq_len=t + 1)).init(jax.random.PRNGKey(3), jnp.zeros((2, t, 768)),
                                 jnp.zeros((2, 1024)),
                                 jnp.zeros((2, t), bool))["params"])
    b_path = str(tmp_path / "b.pth")
    port_ckpt.save_state_dict(b_path, init_fusion(
        cfg, device=CPU, seed=4).state_dict())
    seen = {}
    real = port_cli.train_model

    def spy(*args, **kwargs):
        seen["cfg"], seen["soft"] = args[3], kwargs["soft_targets"]
        return real(*args, **kwargs)

    monkeypatch.setattr(port_cli, "train_model", spy)
    out_dir, prof_dir = tmp_path / "runs", tmp_path / "trace"
    out = port_cli.main([
        "--video_feat_dir", vdir, "--audio_feat_dir", adir, "--batch_size",
        "32", "--num_epochs", "2", "--lr", "1e-3", "--output_dir",
        str(out_dir), "--device", "cpu", "--ema_decay", "0.9",
        "--mixup_alpha", "0.2", "--modality_dropout", "0.2",
        "--distill_from", f"{a_path},{b_path}", "--distill_alpha", "0.3",
        "--distill_temp", "2.0", "--interpret", "--profile_dir",
        str(prof_dir), "--fused"])
    tcfg = seen["cfg"]
    assert (tcfg.ema_decay, tcfg.mixup_alpha, tcfg.modality_dropout,
            tcfg.distill_alpha, tcfg.distill_temp) == (0.9, 0.2, 0.2, 0.3, 2.0)
    teachers = [port_ckpt.load_fusion_checkpoint(p, cfg, CPU).state_dict()
                for p in (a_path, b_path)]
    np.testing.assert_array_equal(seen["soft"], port_distill.teacher_soft_targets(
        cfg, teachers, data, device="cpu"))
    assert len(out.results) == 2 and out.hyperparameters["ema_decay"] == 0.9
    for pattern in ("results_*.json", "best_model_*.pth", "final_model_*.pth",
                    "norm_stats_*.npz", "video_importances_*.csv",
                    "audio_importances_*.csv", "global_importances_*.json"):
        assert len(glob.glob(str(out_dir / pattern))) == 1, pattern
    traces = glob.glob(str(prof_dir / "trace_*.json"))
    assert len(traces) == 1
    with open(traces[0]) as f:
        assert json.load(f)["traceEvents"]


def test_make_flagship_end_to_end(synthetic_feature_dirs, tmp_path):
    """Pool (4 recipes x 2 seeds, one batched call a recipe) → top-half
    teacher → distilled student, at full width for 2 epochs on the CPU: the
    three artifacts, the JAX manifest's keys (``artifacts/flagship``), a
    checkpoint the JAX package reads into its own params tree, and a
    flagship that the port's server resolves and loads bit for bit."""
    from mmer_tpu_torch.scripts import make_flagship

    vdir, adir = synthetic_feature_dirs
    out_dir = tmp_path / "flagship"
    res = make_flagship.main([
        "--pool_seeds", "2", "--student_seeds", "2", "--epochs", "2",
        "--seeds_per_call", "2", "--out_dir", str(out_dir),
        "--video_feat_dir", vdir, "--audio_feat_dir", adir, "--device", "cpu"])
    assert sorted(os.listdir(out_dir)) == ["flagship.msgpack", "manifest.json",
                                           "norm_stats.npz"]
    with open(os.path.join(REPO, "artifacts", "flagship", "manifest.json")) as f:
        reference = json.load(f)
    with open(out_dir / "manifest.json") as f:
        manifest = json.load(f)
    assert manifest == res["manifest"]
    assert manifest.keys() == reference.keys()
    for key in ("student_val_selected", "student_seed_stats", "model_config"):
        assert manifest[key].keys() == reference[key].keys(), key
    assert manifest["teacher_members"] == 4 and len(res["pool"]) == 4
    assert all(len(outs) == 2 for _, outs in res["pool"])
    np.testing.assert_allclose(res["soft_targets"].sum(1), 1.0, atol=1e-5)
    best = res["flagship"]["best_params"]
    mc = manifest["model_config"]
    t = mc["max_seq_len"] - 1
    target = JaxFusion(jax_config.ModelConfig(**mc)).init(
        jax.random.PRNGKey(0), jnp.zeros((1, t, 768)), jnp.zeros((1, 1024)),
        jnp.zeros((1, t), bool))["params"]
    theirs = fusion_from_flax(_np_tree(jax_ckpt.load_params_msgpack(
        str(out_dir / "flagship.msgpack"), target)))
    ckpt, ns, cfg_dict = port_app.resolve_default_fusion(str(out_dir))
    assert ckpt == str(out_dir / "flagship.msgpack") and ns and cfg_dict == mc
    engine = InferenceEngine(CPU, model_cfg=port_config.ModelConfig(**cfg_dict),
                             fusion_params_path=ckpt, norm_stats_path=ns)
    served = engine.fusion.state_dict()
    for name, value in best.items():
        assert torch.equal(theirs[name], value), name
        assert torch.equal(served[name], value), name


def test_seed_sweep_end_to_end(synthetic_feature_dirs, tmp_path):
    """Two seeds in one batched call with both ensemble scorings: per-seed
    results files and the summary with the JAX script's keys
    (``artifacts/seed_sweep``)."""
    from mmer_tpu_torch.scripts import seed_sweep

    vdir, adir = synthetic_feature_dirs
    out_dir = tmp_path / "sweep"
    summary = seed_sweep.main([
        "--seeds", "2", "--epochs", "2", "--seeds_per_call", "2",
        "--out_dir", str(out_dir), "--ensemble_k", "2,3",
        "--ensemble_greedy", "--video_feat_dir", vdir, "--audio_feat_dir",
        adir, "--device", "cpu"])
    ref_dir = os.path.join(REPO, "artifacts", "seed_sweep")
    with open(os.path.join(ref_dir, "summary_winning.json")) as f:
        reference = json.load(f)
    assert set(summary) == set(reference) | {"ensemble", "ensemble_greedy"}
    assert summary["ensemble"]["k=3"] == "skipped"
    assert set(summary["ensemble"]["k=2"]) == {"macro_f1", "accuracy",
                                               "member_mean_f1"}
    assert set(summary["ensemble_greedy"]) == {"k_best", "macro_f1",
                                               "val_f1_path"}
    with open(os.path.join(ref_dir, "results_winning_seed0.json")) as f:
        ref_run = json.load(f)
    assert sorted(os.listdir(out_dir)) == ["results_winning_seed0.json",
                                           "results_winning_seed1.json",
                                           "summary_winning.json"]
    with open(out_dir / "results_winning_seed1.json") as f:
        run = json.load(f)
    assert run.keys() == ref_run.keys()
    assert run["training_progress"][0].keys() == \
        ref_run["training_progress"][0].keys()
    assert len(run["training_progress"]) == 2


def test_scripts_default_to_the_card(synthetic_feature_dirs, tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    from mmer_tpu_torch.scripts import make_flagship, seed_sweep

    vdir, adir = synthetic_feature_dirs
    for main in (make_flagship.main, seed_sweep.main):
        with pytest.raises(RuntimeError, match="CUDA"):
            main(["--epochs", "1", "--out_dir", str(tmp_path),
                  "--video_feat_dir", vdir, "--audio_feat_dir", adir])


def test_profile_train_seeds_mode_runs_on_cpu():
    """``scripts/profile_train.py --seeds S``: one batched epoch timed; no
    device numbers on the CPU."""
    from mmer_tpu_torch.scripts import profile_train

    out = profile_train.main(["--device", "cpu", "--tiny", "--batch_size",
                              "32", "--seeds", "2"])
    assert out["device"] == "cpu" and out["seeds"] == 2
    assert out["steps_per_epoch"] == 5 and out["epoch_s"] > 0
    assert "idle_share" not in out
