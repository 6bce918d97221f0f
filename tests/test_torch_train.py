"""The port's fusion training path against the JAX package's, on the CPU.

Losses and metrics (value and gradient), the copied host data code (catalog,
pipeline, the numpy stratified split against sklearn's, index for index), the
fusion model in training mode (flax BatchNorm over two steps, every
parameter's gradient, dropout's rate and scaling), the optimiser step, and
the slice as a whole: ``train_model`` over a few epochs against the JAX
trainer of the same seed, drawing JAX's shuffles and dropout masks itself,
for the layernorm + weighted-CE recipe at the default dropout and the
batchnorm + focal recipe, then resume and the CLI.
Inputs come from ``np.random.default_rng``; tolerances cover float32
summation order only.
"""

import dataclasses
import glob
import json
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

import mmer_tpu.config as jax_config
import mmer_tpu.data.catalog as jax_catalog
import mmer_tpu.data.pipeline as jax_pipeline
import mmer_tpu.ops.losses as jax_losses
import mmer_tpu.train.loop as jax_loop
import mmer_tpu.train.metrics as jax_metrics
from mmer_tpu.models.fusion import MultimodalEmotionModel as JaxFusion
from mmer_tpu.models.fusion import TokenNorm as JaxTokenNorm
import mmer_tpu_torch.config as port_config
import mmer_tpu_torch.data.catalog as port_catalog
import mmer_tpu_torch.data.check as port_check
import mmer_tpu_torch.data.pipeline as port_pipeline
import mmer_tpu_torch.ops.losses as port_losses
import mmer_tpu_torch.train.loop as port_loop
import mmer_tpu_torch.train.metrics as port_metrics
from mmer_tpu_torch.models.convert import fusion_from_flax
from mmer_tpu_torch.models.fusion import (DropoutMasks, MultimodalEmotionModel,
                                          TokenNorm, dropout, dropout_draws,
                                          dropout_scales, init_fusion)
from mmer_tpu_torch.ops import prng
from mmer_tpu_torch.serve.engine import InferenceEngine
from mmer_tpu_torch.train import checkpoint as port_ckpt
from mmer_tpu_torch.train import cli as port_cli
from mmer_tpu_torch.train.keys import KeySchedule
from tests.conftest import make_tiny_dataset

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CPU = torch.device("cpu")
FUSION_KW = dict(video_dim=768, audio_dim=1024, fused_dim=32, max_seq_len=4,
                 fusion_layers=2, fusion_heads=2, fusion_ffn_dim=64,
                 classifier_hidden_dim=32, compute_dtype="float32",
                 fusion_dropout=0.0, classifier_dropout=0.0)


def _np_tree(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


# -- package boundary and config copies ----------------------------------------

def test_training_modules_load_no_jax_and_no_sklearn():
    code = ("import sys\n"
            "import mmer_tpu_torch.train.cli, mmer_tpu_torch.data.check\n"
            "import mmer_tpu_torch.scripts.probe_attn\n"
            "import mmer_tpu_torch.scripts.profile_fused_blocks\n"
            "import mmer_tpu_torch.train.fused, mmer_tpu_torch.train.distill\n"
            "import mmer_tpu_torch.train.ensemble, mmer_tpu_torch.core.msgpack\n"
            "import mmer_tpu_torch.interpret.ig, mmer_tpu_torch.utils.profiling\n"
            "import mmer_tpu_torch.scripts.make_flagship\n"
            "import mmer_tpu_torch.scripts.seed_sweep\n"
            "import mmer_tpu_torch.models.jax_init\n"
            "import mmer_tpu_torch.models.port_wav2vec2\n"
            "import mmer_tpu_torch.ops.prng, mmer_tpu_torch.train.keys\n"
            "import mmer_tpu_torch.scripts.profile_vivit\n"
            "import mmer_tpu_torch.scripts.profile_w2v2\n"
            "bad = sorted(m for m in sys.modules if m.split('.')[0] in\n"
            "             ('jax', 'flax', 'optax', 'msgpack', 'sklearn',\n"
            "              'mmer_tpu'))\n"
            "print(bad)\n"
            "sys.exit(1 if bad else 0)\n")
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stdout + proc.stderr


@pytest.mark.parametrize("name", ["DataConfig", "TrainConfig"])
def test_train_config_copies_match_jax(name):
    """Field by field; only DataConfig's two directory defaults differ (the
    JAX package's name its own data mount)."""
    ours, theirs = getattr(port_config, name), getattr(jax_config, name)
    local = {"video_feat_dir", "audio_feat_dir"}
    fo = [(f.name, f.type, f.default if f.name not in local else None)
          for f in dataclasses.fields(ours)]
    ft = [(f.name, f.type, f.default if f.name not in local else None)
          for f in dataclasses.fields(theirs)]
    assert fo == ft
    assert ours.__dataclass_params__.frozen == theirs.__dataclass_params__.frozen


# -- losses and metrics ----------------------------------------------------------

def _loss_case(seed, n=13, c=6):
    rng = np.random.default_rng(seed)
    return dict(logits=(rng.normal(size=(n, c)) * 2).astype(np.float32),
                labels=rng.integers(0, c, size=(n,)).astype(np.int32),
                cw=rng.uniform(0.5, 2.0, size=(c,)).astype(np.float32),
                sw=(rng.random(n) > 0.3).astype(np.float32),
                probs=rng.dirichlet(np.ones(c), size=n).astype(np.float32))


LOSSES = {
    "weighted_ce": (lambda m, z, p: m.weighted_cross_entropy(z, p["labels"], p["cw"], p["sw"])),
    "weighted_ce_plain": (lambda m, z, p: m.weighted_cross_entropy(z, p["labels"])),
    "weighted_ce_smoothed": (lambda m, z, p: m.weighted_cross_entropy(
        z, p["labels"], p["cw"], p["sw"], label_smoothing=0.1)),
    "focal": (lambda m, z, p: m.focal_loss(z, p["labels"], 2.0, None, p["sw"])),
    "focal_alpha_mean": (lambda m, z, p: m.focal_loss(z, p["labels"], 1.5, p["cw"])),
    "soft_ce": (lambda m, z, p: m.soft_cross_entropy(z, p["probs"])),
    "soft_ce_temperature": (lambda m, z, p: m.soft_cross_entropy(
        z, p["probs"], 2.0, p["sw"])),
}


@pytest.mark.parametrize("name", sorted(LOSSES))
def test_loss_value_and_gradient_match_jax(name):
    case = _loss_case(1)
    fn = LOSSES[name]
    jp = {k: jnp.asarray(v) for k, v in case.items()}
    want, want_grad = jax.value_and_grad(
        lambda z: fn(jax_losses, z, jp))(jp["logits"])
    tp = {k: torch.from_numpy(v) for k, v in case.items()}
    z = tp["logits"].clone().requires_grad_(True)
    got = fn(port_losses, z, tp)
    got.backward()
    np.testing.assert_allclose(float(got.detach()), float(want), rtol=1e-6,
                               atol=1e-7)
    np.testing.assert_allclose(z.grad.numpy(), np.asarray(want_grad),
                               rtol=1e-5, atol=1e-7)


def test_all_padded_batch_has_zero_loss_and_gradient():
    case = _loss_case(2)
    z = torch.from_numpy(case["logits"]).requires_grad_(True)
    sw = torch.zeros(len(case["labels"]))
    loss = port_losses.weighted_cross_entropy(
        z, torch.from_numpy(case["labels"]), torch.from_numpy(case["cw"]), sw)
    loss.backward()
    assert float(loss) == 0.0 and not z.grad.any()


def test_metrics_match_jax():
    rng = np.random.default_rng(3)
    labels = rng.integers(0, 6, size=(57,)).astype(np.int32)
    preds = rng.integers(0, 5, size=(57,)).astype(np.int32)   # class 5 never predicted
    sw = (rng.random(57) > 0.2).astype(np.float32)
    for weight in (None, sw):
        want = np.asarray(jax_metrics.confusion_matrix(
            jnp.asarray(labels), jnp.asarray(preds), 6,
            None if weight is None else jnp.asarray(weight)))
        got = port_metrics.confusion_matrix(
            torch.from_numpy(labels), torch.from_numpy(preds), 6,
            None if weight is None else torch.from_numpy(weight)).numpy()
        np.testing.assert_array_equal(got, want)
        assert port_metrics.accuracy_from_confusion(got) == \
            jax_metrics.accuracy_from_confusion(want)
        assert port_metrics.prf_from_confusion(got) == \
            jax_metrics.prf_from_confusion(want)
    empty = np.zeros((6, 6))
    assert port_metrics.accuracy_from_confusion(empty) == 0.0
    assert port_metrics.prf_from_confusion(empty) == \
        jax_metrics.prf_from_confusion(empty)


# -- host data code ----------------------------------------------------------------

REAL_COUNTS = (1183, 1463, 1462, 1463, 1463, 1462)


def _label_vectors():
    rng = np.random.default_rng(4)
    real = np.repeat(np.arange(6), REAL_COUNTS)
    rng.shuffle(real)
    return {
        "real_class_counts": real,
        "random_200": rng.integers(0, 6, 200),
        "three_classes_37": rng.integers(0, 3, 37) + 2,
        "tied_remainders": np.repeat(np.arange(6), [20, 20, 20, 20, 20, 21]),
        "sorted_by_class": np.repeat(np.arange(4), [9, 17, 30, 11]),
    }


@pytest.mark.parametrize("seed", [42, 0, 7])
@pytest.mark.parametrize("case", sorted(_label_vectors()))
def test_stratified_splits_equal_sklearn_index_for_index(case, seed):
    labels = _label_vectors()[case]
    want = jax_pipeline.stratified_splits(labels, seed=seed)      # sklearn
    got = port_pipeline.stratified_splits(labels, seed=seed)      # numpy
    for g, w in zip(got, want):
        assert g.dtype == np.int32
        np.testing.assert_array_equal(g, w)
    assert sorted(np.concatenate(got).tolist()) == list(range(len(labels)))


def test_stratified_splits_reject_a_singleton_class():
    with pytest.raises(ValueError):
        port_pipeline.stratified_splits(np.array([0] * 10 + [1]))


def test_catalog_copy_matches_jax(synthetic_feature_dirs):
    vdir, adir = synthetic_feature_dirs
    for pairing in ("key", "positional"):
        want = jax_catalog.build_catalog(vdir, adir, pairing)
        got = port_catalog.build_catalog(vdir, adir, pairing)
        assert [dataclasses.astuple(e) for e in got] == \
            [dataclasses.astuple(e) for e in want]
    for name in ("1001_DFA_ANG_XX_faces_mp4_features.npy",
                 "Video_Speech_Actor_01_01-01-02-01-02-01-12_voice_mp4_features.npy",
                 "Video_Speech_Actor_01_01-01-07-01-02-01-12_features.npy"):
        assert port_catalog.label_from_name(name) == jax_catalog.label_from_name(name)
        assert port_catalog.sample_key(name) == jax_catalog.sample_key(name)
    with pytest.raises(FileNotFoundError):
        port_catalog.build_catalog(str(vdir) + "_missing", adir)


@pytest.mark.parametrize("recipe", ["v2", "v1"])
def test_load_dataset_copy_matches_jax(synthetic_feature_dirs, recipe):
    vdir, adir = synthetic_feature_dirs
    kw = dict(video_feat_dir=str(vdir), audio_feat_dir=str(adir))
    if recipe == "v1":
        kw.update(normalization="per_sample", oversample_neutral=True)
    want_d, want_s = jax_pipeline.load_dataset(jax_config.DataConfig(**kw))
    got_d, got_s = port_pipeline.load_dataset(port_config.DataConfig(**kw))
    for f in dataclasses.fields(want_d):
        w, g = getattr(want_d, f.name), getattr(got_d, f.name)
        if isinstance(w, np.ndarray):
            assert g.dtype == w.dtype, f.name
            np.testing.assert_array_equal(g, w, err_msg=f.name)
        else:
            assert g == w, f.name
    for f in dataclasses.fields(want_s):
        np.testing.assert_array_equal(getattr(got_s, f.name),
                                      getattr(want_s, f.name), err_msg=f.name)


def test_check_copy_reports_like_jax(synthetic_feature_dirs, capsys, tmp_path):
    import mmer_tpu.data.check as jax_check

    vdir, adir = synthetic_feature_dirs
    argv = ["--video_dir", str(vdir), "--audio_dir", str(adir), "-n", "3"]
    assert jax_check.main(argv) == 0
    want = capsys.readouterr().out
    assert port_check.main(argv) == 0
    assert capsys.readouterr().out == want
    # A bad artifact makes both exit 1.
    bad_v, bad_a = tmp_path / "v", tmp_path / "a"
    bad_v.mkdir()
    bad_a.mkdir()
    np.save(bad_v / "1001_DFA_ANG_XX_faces_mp4_features.npy", np.zeros((2, 5)))
    np.save(bad_a / "1001_DFA_ANG_XX_voice_mp4_features.npy", np.zeros(1024))
    argv = ["--video_dir", str(bad_v), "--audio_dir", str(bad_a)]
    assert port_check.main(argv) == jax_check.main(argv) == 1


# -- the fusion model in training mode -----------------------------------------------

def test_batchnorm_matches_flax_over_two_steps():
    """Forward in training mode and the running statistics after each of two
    steps (momentum 0.99, eps 1e-5, biased variance in both places, padded
    rows included), then evaluation mode on the running statistics."""
    rng = np.random.default_rng(5)
    jmod = JaxTokenNorm(kind="batchnorm")
    xs = [rng.normal(size=(5, 3, 16)).astype(np.float32) * 2 + 1 for _ in range(3)]
    variables = _np_tree(jmod.init(jax.random.PRNGKey(0), jnp.asarray(xs[0])))
    variables["params"]["BatchNorm_0"]["scale"] = rng.normal(size=16).astype(np.float32)
    variables["params"]["BatchNorm_0"]["bias"] = rng.normal(size=16).astype(np.float32)
    port = TokenNorm("batchnorm", 16, device=CPU)
    with torch.no_grad():
        port.bn.weight.copy_(torch.from_numpy(variables["params"]["BatchNorm_0"]["scale"]))
        port.bn.bias.copy_(torch.from_numpy(variables["params"]["BatchNorm_0"]["bias"]))
    port.train()
    for x in xs[:2]:
        want, upd = jmod.apply(variables, jnp.asarray(x), train=True,
                               mutable=["batch_stats"])
        variables = {"params": variables["params"],
                     "batch_stats": _np_tree(upd["batch_stats"])}
        got = port(torch.from_numpy(x))
        np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                                   atol=2e-6, rtol=1e-5)
        stats = variables["batch_stats"]["BatchNorm_0"]
        np.testing.assert_allclose(port.bn.running_mean.numpy(), stats["mean"],
                                   atol=1e-7, rtol=1e-6)
        np.testing.assert_allclose(port.bn.running_var.numpy(), stats["var"],
                                   atol=1e-7, rtol=1e-6)
    # torch's own BatchNorm1d defaults would have moved the statistics ten
    # times as far, with the unbiased variance.
    assert abs(float(port.bn.running_mean.mean())) < 0.05
    port.eval()
    want = jmod.apply(variables, jnp.asarray(xs[2]), train=False)
    np.testing.assert_allclose(port(torch.from_numpy(xs[2])).detach().numpy(),
                               np.asarray(want), atol=2e-6, rtol=1e-5)


def _fusion_batch(seed, b=6, t=3):
    rng = np.random.default_rng(seed)
    lengths = rng.integers(1, t + 1, size=b)
    return dict(video=rng.normal(size=(b, t, 768)).astype(np.float32),
                audio=rng.normal(size=(b, 1024)).astype(np.float32),
                mask=np.arange(t)[None, :] >= lengths[:, None],
                labels=rng.integers(0, 6, size=b).astype(np.int32),
                sw=np.array([1, 1, 1, 1, 1, 0], np.float32)[:b])


@pytest.mark.parametrize("norm,loss", [("layernorm", "weighted_ce"),
                                       ("batchnorm", "focal")])
def test_fusion_training_gradients_match_jax(norm, loss):
    """One training-mode forward and backward, dropout off: the loss, every
    parameter's gradient and (batchnorm) the updated running statistics.  The
    JAX gradient tree goes through the same converter as the params: the
    conversion is a relabelling and transposition, so it carries gradients."""
    kw = dict(FUSION_KW, norm=norm)
    batch = _fusion_batch(6)
    jmodel = JaxFusion(jax_config.ModelConfig(**kw))
    variables = _np_tree(dict(jmodel.init(
        jax.random.PRNGKey(1), batch["video"], batch["audio"], batch["mask"])))
    rng = np.random.default_rng(7)
    variables["params"] = jax.tree_util.tree_map(
        lambda a: a + 0.05 * rng.normal(size=a.shape).astype(np.float32),
        variables["params"])
    stats = variables.get("batch_stats", {})
    cw = np.linspace(0.5, 1.5, 6).astype(np.float32)
    jloss = jax_loop._loss_fn(jax_config.TrainConfig(loss=loss))

    def loss_of(params):
        v = {"params": params}
        if stats:
            v["batch_stats"] = stats
            (_, logits, _), upd = jmodel.apply(
                v, batch["video"], batch["audio"], batch["mask"], train=True,
                mutable=["batch_stats"])
            return jloss(logits, batch["labels"], cw, batch["sw"]), upd["batch_stats"]
        _, logits, _ = jmodel.apply(v, batch["video"], batch["audio"],
                                    batch["mask"], train=True)
        return jloss(logits, batch["labels"], cw, batch["sw"]), {}

    (want, new_stats), grads = jax.value_and_grad(loss_of, has_aux=True)(
        variables["params"])
    want_grads = fusion_from_flax(_np_tree(grads), _np_tree(new_stats) or None)

    port = MultimodalEmotionModel(port_config.ModelConfig(**kw), device=CPU)
    port.load_state_dict(fusion_from_flax(variables["params"], stats or None))
    port.train()
    _, logits, _ = port(torch.from_numpy(batch["video"]),
                        torch.from_numpy(batch["audio"]),
                        torch.from_numpy(batch["mask"]))
    got = port_loop._loss_fn(port_config.TrainConfig(loss=loss))(
        logits, torch.from_numpy(batch["labels"]).long(), torch.from_numpy(cw),
        torch.from_numpy(batch["sw"]))
    got.backward()
    np.testing.assert_allclose(float(got), float(want), rtol=1e-5)
    named = dict(port.named_parameters())
    assert set(named) | set(dict(port.named_buffers())) == set(want_grads)
    # Gradients that are zero in exact arithmetic (a key bias under the
    # softmax, a bias in front of a BatchNorm) are float noise of ~1e-8 on
    # both sides: the absolute bound scales with the largest gradient.
    largest = max(float(want_grads[name].abs().max()) for name in named)
    for name, p in named.items():
        w = want_grads[name].numpy()
        np.testing.assert_allclose(
            p.grad.numpy(), w, rtol=1e-4,
            atol=1e-4 * float(np.abs(w).max()) + 1e-6 * largest, err_msg=name)
    for name, buf in port.named_buffers():      # the updated running statistics
        np.testing.assert_allclose(buf.numpy(), want_grads[name].numpy(),
                                   rtol=1e-5, atol=1e-6, err_msg=name)


def _masks(cfg, b, t, key):
    """A training forward's masks for a (b, t) batch under the dropout key
    ``key``, drawn as the trainer draws them."""
    draws = dropout_draws(cfg, b, t)
    return DropoutMasks(prng.DrawPlan(draws, CPU).draw([key]),
                        dropout_scales(cfg, CPU))


def test_dropout_rate_scaling_and_generator():
    """Keep masks from JAX's Bernoulli draws: about the rate dropped, the
    rest scaled as XLA scales them (a float32 ``x * float32(1 / keep)``, a
    bfloat16 ``x / bfloat16(keep)`` rounded once), the same key giving the
    same output; the identity in evaluation mode or at rate 0."""
    x = torch.ones(200, 500)
    draw = prng.Draw((), (200, 500), "mask", 0.7)
    mask = prng.DrawPlan([draw], CPU).draw([prng.PRNGKey(0)])[0]
    scale = float(np.float32(1.0) / np.float32(0.7))
    y = dropout(x, 0.3, True, DropoutMasks([mask], [scale]))
    zero = float((y == 0).float().mean())
    assert abs(zero - 0.3) < 0.01
    assert torch.equal(y[y != 0], torch.full_like(y[y != 0], scale))
    assert torch.equal(y, dropout(x, 0.3, True, DropoutMasks([mask], [scale])))
    assert dropout(x, 0.3, False) is x and dropout(x, 0.0, True) is x
    with pytest.raises(ValueError, match="masks"):
        dropout(x, 0.3, True)
    xb = (torch.rand(200, 500, generator=torch.Generator().manual_seed(1))
          .to(torch.bfloat16))
    yb = dropout(xb, 0.3, True, DropoutMasks([mask.to(torch.bfloat16)],
                                             [torch.tensor(0.7, dtype=torch.bfloat16)]))
    want = jnp.where(jnp.asarray(mask.numpy()) > 0,
                     jnp.asarray(xb.float().numpy(), jnp.bfloat16) / 0.7, 0)
    np.testing.assert_array_equal(yb.float().numpy(),
                                  np.asarray(want.astype(jnp.float32)))


def test_fusion_dropout_is_on_only_in_training_mode():
    kw = dict(FUSION_KW, fusion_dropout=0.2, classifier_dropout=0.2)
    cfg = port_config.ModelConfig(**kw)
    batch = _fusion_batch(8)
    model = init_fusion(cfg, device=CPU, seed=0)
    args = (torch.from_numpy(batch["video"]), torch.from_numpy(batch["audio"]),
            torch.from_numpy(batch["mask"]))
    rows, t = batch["video"].shape[:2]
    assert not model.training                    # init_fusion returns .eval()
    with torch.no_grad():
        base = model(*args)[1]
        assert torch.equal(model(*args)[1], base)
        model.train()
        a = model(*args, masks=_masks(cfg, rows, t, prng.PRNGKey(1)))[1]
        b = model(*args, masks=_masks(cfg, rows, t, prng.PRNGKey(1)))[1]
        c = model(*args, masks=_masks(cfg, rows, t, prng.PRNGKey(2)))[1]
    assert torch.equal(a, b) and not torch.equal(a, c)
    assert not torch.allclose(a, base, atol=1e-3)


# -- the optimiser ---------------------------------------------------------------------

def test_optimizer_steps_match_optax():
    """clip (optax's form) → L2 into the gradient → Adam → lr, over steps
    whose gradient norms lie on both sides of the clip, with an lr change."""
    rng = np.random.default_rng(9)
    shapes = [(7, 5), (5,), (3, 4, 2)]
    params = [rng.normal(size=s).astype(np.float32) for s in shapes]
    grads = [[(rng.normal(size=s) * scale).astype(np.float32) for s in shapes]
             for scale in (3.0, 0.01, 1.0, 0.1)]
    cfg = jax_config.TrainConfig(lr=1e-2, weight_decay=1e-2)
    opt = jax_loop.make_optimizer(cfg)
    jparams = [jnp.asarray(p) for p in params]
    state = opt.init(jparams)

    module = torch.nn.ParameterList(
        [torch.nn.Parameter(torch.from_numpy(p.copy())) for p in params])
    topt = port_loop.make_optimizer(module, port_config.TrainConfig(
        lr=1e-2, weight_decay=1e-2))
    for step, gs in enumerate(grads):
        if step == 2:
            state = jax_loop.set_learning_rate(state, 3e-3)
            port_loop.set_learning_rate(topt, 3e-3)
        updates, state = opt.update([jnp.asarray(g) for g in gs], state, jparams)
        jparams = optax.apply_updates(jparams, updates)
        for p, g in zip(module, gs):
            p.grad = torch.from_numpy(g.copy())
        norm = port_loop.clip_by_global_norm(list(module), cfg.clip_norm)
        np.testing.assert_allclose(
            float(norm), np.sqrt(sum(float((g ** 2).sum()) for g in gs)), rtol=1e-5)
        topt.step()
        for p, w in zip(module, jparams):
            np.testing.assert_allclose(p.detach().numpy(), np.asarray(w),
                                       rtol=2e-5, atol=2e-6)


def test_plateau_scheduler_copy_matches_jax():
    rng = np.random.default_rng(10)
    ours = port_loop.PlateauScheduler(0.3, 2)
    theirs = jax_loop.PlateauScheduler(0.3, 2)
    lr_o = lr_t = 1e-3
    values = np.abs(np.cumsum(rng.normal(size=60) * 0.05)) + 0.5
    for v in list(values) + [1e-9] * 30:
        lr_o, lr_t = ours.step(float(v), lr_o), theirs.step(float(v), lr_t)
        assert lr_o == lr_t and ours.num_bad == theirs.num_bad
    assert lr_o < 1e-3


# -- the slice as a whole ----------------------------------------------------------------

TRAIN_KW = dict(max_seq_len=4, fusion_layers=1, fusion_heads=2, fused_dim=32,
                fusion_ffn_dim=64, classifier_hidden_dim=32,
                compute_dtype="float32", fusion_dropout=0.0,
                classifier_dropout=0.0)


def _jax_initial_state(model_kw, data, seed):
    """The JAX run's initial variables for ``seed``, carried into the port's
    state dict, and its batch statistics."""
    rng = jax.random.PRNGKey(seed)
    rng, init_key = jax.random.split(rng)
    variables = JaxFusion(jax_config.ModelConfig(**model_kw)).init(
        {"params": init_key}, jnp.asarray(data.video[:2]),
        jnp.asarray(data.audio[:2]), jnp.asarray(data.pad_mask[:2]))
    variables = _np_tree(dict(variables))
    return fusion_from_flax(variables), variables.get("batch_stats")


def _record_lrs(monkeypatch, module):
    seen = []
    real = module.PlateauScheduler.step

    def step(self, value, lr):
        out = real(self, value, lr)
        seen.append(out)
        return out

    monkeypatch.setattr(module.PlateauScheduler, "step", step)
    return seen


@pytest.mark.parametrize("norm,loss,best_metric,lr,min_delta,rate,loss_rtol", [
    ("layernorm", "weighted_ce", "val_loss", 2e-3, 0.03, 0.1, 1e-4),
    # Batch statistics of 32 rows under rsqrt(var + 1e-5), running averages
    # of them in the evaluations, and a larger lr (so that the validation
    # loss turns and the scheduler cuts it): summation order shows as 1.3e-4.
    # At dropout 0: that noise moves one of the 20 validation rows across a
    # class boundary at dropout 0.1, and the matrices are held equal.
    ("batchnorm", "focal", "val_acc", 3e-3, 0.01, 0.0, 3e-4)])
def test_train_model_matches_jax(monkeypatch, norm, loss, best_metric, lr,
                                 min_delta, rate, loss_rtol):
    """Several epochs of the whole trainer, both recipes, the port drawing
    JAX's epoch-loop key schedule itself (no draw is injected): per-epoch
    losses within ``loss_rtol`` relative, confusion-matrix-derived metrics
    and the final confusion matrix equal, the lr trajectory (the plateau
    scheduler cuts it), the best epoch and the early-stop epoch equal."""
    data, splits = make_tiny_dataset(seed=0, n=200, t=3, separable=True)
    model_kw = dict(TRAIN_KW, norm=norm, fusion_dropout=rate,
                    classifier_dropout=rate)
    train_kw = dict(num_epochs=8, lr=lr, loss=loss, save_checkpoints=False,
                    patience=2, min_delta=min_delta, scheduler_patience=0,
                    scheduler_factor=0.5, best_metric=best_metric)
    jax_lrs = _record_lrs(monkeypatch, jax_loop)
    want = jax_loop.train_model(
        data, splits, jax_config.ModelConfig(**model_kw),
        jax_config.TrainConfig(**train_kw), batch_size=32, seed=0, verbose=False)

    state, init_stats = _jax_initial_state(model_kw, data, 0)
    # The port's default initial weights for the seed are the JAX trainer's.
    port_init = init_fusion(port_config.ModelConfig(**model_kw), device=CPU,
                            seed=0).state_dict()
    assert set(port_init) == set(state)
    for name in state:
        assert torch.equal(port_init[name], state[name]), name
    port_lrs = _record_lrs(monkeypatch, port_loop)
    got = port_loop.train_model(
        data, splits, port_config.ModelConfig(**model_kw),
        port_config.TrainConfig(**train_kw), batch_size=32, seed=0,
        verbose=False, device="cpu")
    # The run exercises what it claims to: an early stop and an lr cut.
    assert 3 <= len(want.results) < train_kw["num_epochs"]
    assert min(jax_lrs) < train_kw["lr"]
    assert len(got.results) == len(want.results)            # early-stop epoch
    assert got.best_epoch == want.best_epoch
    np.testing.assert_allclose(port_lrs, jax_lrs, rtol=1e-12)
    for g, w in zip(got.results, want.results):
        assert g.keys() == w.keys()
        for key in w:
            if key.endswith("_loss"):
                np.testing.assert_allclose(g[key], w[key], rtol=loss_rtol,
                                           err_msg=key)
            else:       # derived from equal confusion matrices
                np.testing.assert_allclose(g[key], w[key], rtol=1e-12, err_msg=key)
    np.testing.assert_array_equal(got.confusion, want.confusion)
    np.testing.assert_allclose(got.best_val_loss, want.best_val_loss,
                               rtol=loss_rtol)
    np.testing.assert_allclose(got.best_score, want.best_score, rtol=loss_rtol)
    assert set(got.hyperparameters) == set(want.hyperparameters)
    # The JAX trainer's default mesh spans its 8 virtual devices; the port's
    # default (no mesh_cfg) is one device.
    assert got.hyperparameters["mesh"] == {"data": 1, "model": 1}
    assert got.hyperparameters["device"] == "cpu"
    # One training-pass time per epoch run, all inside the run's wall time.
    assert len(got.train_epoch_seconds) == len(got.results)
    assert 0 < sum(got.train_epoch_seconds) <= got.hyperparameters[
        "train_wall_seconds"]
    # The final weights, a few dozen Adam steps from the same start (the JAX
    # output carries no running statistics: parameters only).
    final = fusion_from_flax(_np_tree(want.final_params), init_stats)
    assert_weights_match(got.final_params, final, norm)


# Parameters whose gradient is zero in exact arithmetic: the attention's key
# bias (a softmax ignores a shift of the scores) and what only shifts the
# input of a BatchNorm, which removes the shift: a Dense bias before one, the
# output norm's bias (through one Dense into the classifier's first), the
# last layer's norm2 bias (through the masked mean pool into the output norm).  Adam scales their float noise
# to lr-sized steps, in whichever direction the noise fell on each side.
ZERO_GRAD = {"layernorm": ("self_attn.key.bias",),
             "batchnorm": ("self_attn.key.bias", "video_proj.bias",
                           "audio_proj.bias", "hidden_0.bias", "hidden_1.bias",
                           "out_norm.bn.bias", "layers.0.norm2.bias")}


def assert_weights_match(got, want, norm="layernorm", rel=1e-4):
    """Final weights of a port run against the JAX run's: every tensor
    within ``rel`` relative (L2) and elementwise within 5e-3 relative + 5e-4
    (a gradient near 0, which Adam normalises, leaves single elements that
    far apart); a zero-gradient tensor (:data:`ZERO_GRAD`) at its noise's
    size on both sides."""
    for name, value in want.items():
        if "running_" in name:
            continue
        ours = got[name]
        if name.endswith(ZERO_GRAD[norm]):
            assert float(ours.abs().max()) < 1e-2, name
            assert float(value.abs().max()) < 1e-2, name
            continue
        assert float((ours - value).norm()) <= rel * float(value.norm()), name
        np.testing.assert_allclose(ours.numpy(), value.numpy(), rtol=5e-3,
                                   atol=5e-4, err_msg=name)


def test_tail_batch_padding_equals_ragged_batch():
    """37 training samples at batch 16: the last batch holds 5 samples and 11
    sentinels; one epoch equals three ragged steps taken by hand."""
    data, splits = make_tiny_dataset(seed=1, n=96, t=3, separable=True)
    cfg = port_config.ModelConfig(**TRAIN_KW)
    tcfg = port_config.TrainConfig(lr=1e-3)
    idx = torch.arange(37)
    dev = port_loop.device_data(data, CPU)
    cw = torch.from_numpy(splits.class_weights)

    def fresh():
        model = init_fusion(cfg, device=CPU, seed=0)
        return model, port_loop.make_optimizer(model, tcfg)

    model, opt = fresh()
    perm = torch.randperm(37, generator=torch.Generator().manual_seed(3))
    keys = KeySchedule([0], "loop", cfg, tcfg, 16, 3, CPU)
    mean_loss = port_loop.train_epoch(model, opt, dev, idx, cw, tcfg, 16,
                                      keys=keys, perm=perm)

    ref, ropt = fresh()
    ref.train()
    losses = []
    for b in idx[perm].split(16):
        _, logits, _ = ref(dev["video"][b], dev["audio"][b], dev["pad_mask"][b])
        loss = port_losses.weighted_cross_entropy(logits, dev["labels"][b], cw)
        ropt.zero_grad()
        loss.backward()
        port_loop.clip_by_global_norm(list(ref.parameters()), tcfg.clip_norm)
        ropt.step()
        losses.append(float(loss))
    np.testing.assert_allclose(float(mean_loss), np.mean(losses), rtol=1e-6)
    for (name, p), q in zip(model.named_parameters(), ref.parameters()):
        if name.endswith("self_attn.key.bias"):
            # Its gradient is zero in exact arithmetic (a softmax ignores a
            # shift of the scores); Adam scales the float noise to lr-sized
            # steps, in whichever direction the noise fell.
            continue
        torch.testing.assert_close(p, q, rtol=1e-5, atol=1e-6, msg=name)
    assert not model.training            # train_epoch leaves the model in eval


def test_resume_equals_uninterrupted_run(tmp_path):
    """Dropout on, batchnorm, a scheduler that cuts the lr: a run resumed from
    the epoch-2 checkpoint repeats epochs 3-4 of the uninterrupted run
    exactly (weights, optimiser moments, generators and loop scalars)."""
    data, splits = make_tiny_dataset(seed=2, n=120, t=3, separable=True)
    cfg = port_config.ModelConfig(**dict(TRAIN_KW, norm="batchnorm",
                                         fusion_dropout=0.1,
                                         classifier_dropout=0.1))
    kw = dict(num_epochs=4, lr=1e-3, loss="focal", scheduler_patience=0,
              checkpoint_every=2, patience=50)

    def run(out_dir, **extra):
        return port_loop.train_model(
            data, splits, cfg,
            port_config.TrainConfig(output_dir=str(out_dir), **kw),
            batch_size=32, seed=3, verbose=False, device="cpu", **extra)

    full = run(tmp_path / "full")
    ckpt_dir = tmp_path / "full" / "checkpoints"
    assert sorted(os.listdir(ckpt_dir)) == [
        "loop_000002.json", "loop_000004.json", "state_000002.pth",
        "state_000004.pth"]
    assert port_ckpt.latest_checkpoint(str(ckpt_dir)).endswith("state_000004.pth")
    os.remove(ckpt_dir / "state_000004.pth")
    resumed = run(tmp_path / "resumed", resume_dir=str(ckpt_dir))
    assert [r["epoch"] for r in resumed.results] == [3, 4]
    assert resumed.results == full.results[2:]
    assert resumed.best_epoch == full.best_epoch
    assert resumed.best_score == full.best_score
    for name, value in full.final_params.items():
        assert torch.equal(resumed.final_params[name], value), name
    for name, value in full.best_params.items():
        assert torch.equal(resumed.best_params[name], value), name
    np.testing.assert_array_equal(resumed.confusion, full.confusion)
    assert port_ckpt.latest_checkpoint(str(tmp_path / "nowhere")) is None


def test_train_model_rejects_what_it_does_not_implement():
    data, splits = make_tiny_dataset(seed=0, n=96, t=3)
    cfg = port_config.ModelConfig(**TRAIN_KW)
    # The epoch loop's schedule (fused=False) has no opt-in, as in JAX, and
    # names the one given; the fused schedule refuses a batchnorm model.
    with pytest.raises(ValueError, match="mixup_alpha"):
        port_loop.train_model(data, splits,
                              port_config.ModelConfig(**TRAIN_KW, norm="batchnorm"),
                              port_config.TrainConfig(mixup_alpha=0.2),
                              device="cpu", verbose=False)
    with pytest.raises(ValueError, match="batchnorm"):
        port_loop.train_model(data, splits,
                              port_config.ModelConfig(**TRAIN_KW, norm="batchnorm"),
                              port_config.TrainConfig(mixup_alpha=0.2),
                              device="cpu", verbose=False, fused=True)
    with pytest.raises(ValueError, match="unknown loss"):
        port_loop.train_model(data, splits, cfg,
                              port_config.TrainConfig(loss="hinge", num_epochs=1,
                                                      save_checkpoints=False),
                              device="cpu", verbose=False)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            port_loop.train_model(data, splits, cfg, port_config.TrainConfig())


@pytest.mark.parametrize("norm", ["layernorm", "batchnorm"])
def test_cli_round_trip_and_serving(synthetic_feature_dirs, tmp_path, norm):
    """Feature folders → the CLI on the CPU → results JSON, best/final .pth,
    norm stats; the engine then loads the trained head."""
    vdir, adir = synthetic_feature_dirs
    out_dir = tmp_path / "runs"
    out = port_cli.main([
        "--video_feat_dir", str(vdir), "--audio_feat_dir", str(adir),
        "--batch_size", "32", "--num_epochs", "2", "--lr", "1e-3",
        "--norm", norm, "--loss", "focal" if norm == "batchnorm" else "weighted_ce",
        "--output_dir", str(out_dir), "--device", "cpu", "--seed", "1"])
    assert len(out.results) == 2 and out.best_epoch in (1, 2)
    for pattern in ("results_bs32_ep2_lr0.001_*.json", "best_model_bs32_*.pth",
                    "final_model_bs32_*.pth", "norm_stats_bs32_*.npz"):
        assert len(glob.glob(str(out_dir / pattern))) == 1, pattern
    with open(out.results_path) as f:
        saved = json.load(f)
    assert saved["training_progress"] == out.results
    assert saved["best_model"] == {"epoch": out.best_epoch}
    assert saved["hyperparameters"]["device"] == "cpu"
    n_test = int(np.sum(saved["confusion_matrix"]))
    assert n_test == int(out.confusion.sum()) > 0
    assert np.isfinite([r["train_loss"] for r in out.results]).all()

    best = port_ckpt.load_state_dict(out.best_model_path)
    buffers = [k for k in best if "running_" in k]
    assert bool(buffers) == (norm == "batchnorm")
    engine = InferenceEngine(
        "cpu", model_cfg=port_config.ModelConfig(norm=norm),
        fusion_params_path=out.best_model_path,
        norm_stats_path=out.norm_stats_path)
    for key, value in engine.fusion.state_dict().items():
        assert torch.equal(value, best[key]), key
    assert not engine.fusion.training
    assert set(engine.norm_stats) == {"video_mean", "video_std", "audio_mean",
                                      "audio_std"}
    probs = engine._fusion_probs(np.zeros((2, 5, 768), np.float32),
                                 np.zeros((2, 1024), np.float32),
                                 np.zeros((2, 5), bool))
    assert probs.shape == (2, 6) and np.allclose(probs.sum(-1), 1, atol=1e-5)


def test_cli_defaults_to_the_card(synthetic_feature_dirs, tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    vdir, adir = synthetic_feature_dirs
    with pytest.raises(RuntimeError, match="CUDA"):
        port_cli.main(["--video_feat_dir", str(vdir), "--audio_feat_dir",
                       str(adir), "--num_epochs", "1", "--output_dir",
                       str(tmp_path)])
