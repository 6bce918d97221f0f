"""The port's scale-out path on the CPU: data- and tensor-parallel extraction
and training over ``torch.distributed`` gloo worlds of 2 and 4 ranks,
against the port's own single-device runs and the JAX package's runs on its
8-device CPU mesh.

Two worlds are spawned once for the module (``parallel/launch.py``), in the
background while the JAX runs go on in this process; each rank runs a list
of cases and returns numpy results.  The rank bodies are this module's
functions, so the module imports nothing of JAX at the top: a spawned rank
imports it.  Inputs come from ``np.random.default_rng``.  Tolerances: f32
embeddings 1e-5 (the JAX mesh tests' bound), trajectories rtol = atol = 2e-4
(``tests/test_fused_multichip.py``'s), the port against JAX at
``tests/test_torch_train.py``'s bounds (losses 1e-4 relative, equal
confusion matrices).
"""

from __future__ import annotations

import concurrent.futures as cf
import dataclasses
import re

import numpy as np
import pytest
import torch
import torch.distributed as dist

import mmer_tpu_torch.config as port_config
import mmer_tpu_torch.data.pipeline as port_pipeline
import mmer_tpu_torch.train.loop as port_loop
from mmer_tpu_torch.train.keys import KeySchedule
from mmer_tpu_torch.config import MeshConfig
from mmer_tpu_torch.core.mesh import create_mesh, pad_to_multiple
from mmer_tpu_torch.models.fusion import init_fusion
from mmer_tpu_torch.models.wav2vec2 import AudioEmbedder
from mmer_tpu_torch.parallel import scaling
from mmer_tpu_torch.parallel.launch import spawn_cpu_world
from mmer_tpu_torch.parallel.sharding import (fusion_param_spec, gather_params,
                                              shard_params)
from mmer_tpu_torch.preprocess.extract import VideoFeatureExtractor

from torch_threads import few_threads  # noqa: F401

CPU = torch.device("cpu")
# The JAX mesh tests' tiny extractors (tests/test_extract_multichip.py).
TINY_V = dict(image_size=(32, 32), patch_size=(16, 16), num_frames=8,
              tubelet_size=4, dim=64, depth=2, heads=2, dim_head=32,
              mlp_dim=128, compute_dtype="float32")
TINY_A = dict(hidden_dim=64, num_layers=2, num_heads=2, ffn_dim=128,
              conv_dims=(32,) * 7, num_conv_pos_embeddings=16,
              num_conv_pos_embedding_groups=4, compute_dtype="float32")
# The port's own sharded-vs-single runs: a narrow fusion model, dropout on.
SMALL = dict(max_seq_len=4, fusion_layers=2, fusion_heads=2, fused_dim=32,
             fusion_ffn_dim=64, classifier_hidden_dim=32,
             compute_dtype="float32", fusion_dropout=0.1,
             classifier_dropout=0.1)
# Against JAX: the same model, dropout on (the port draws JAX's stream).
JAX_MODEL = SMALL
JAX_BN = dict(JAX_MODEL, norm="batchnorm")
TRAIN = dict(num_epochs=3, lr=1e-3, save_checkpoints=False, patience=10 ** 9)
OPT_INS = dict(ema_decay=0.8, mixup_alpha=0.4, modality_dropout=0.3,
               distill_alpha=0.5, distill_temp=2.0)
DISTILL = dict(distill_alpha=0.5, distill_temp=2.0)
BATCH = 32
TRAJ = dict(rtol=2e-4, atol=2e-4)


def _dataset(seed=7, n=128, t=3):
    """``tests/conftest.py:make_tiny_dataset(seed, n, t, separable=True)``
    with the port's pipeline (its split is sklearn's, sample for sample)."""
    rng = np.random.default_rng(seed)
    labels = rng.integers(0, 6, size=(n,)).astype(np.int32)
    lengths = rng.integers(1, t + 1, size=(n,)).astype(np.int32)
    video = rng.normal(size=(n, t, 768)).astype(np.float32)
    audio = rng.normal(size=(n, 1024)).astype(np.float32)
    video[:, :, 0] += labels[:, None] * 2.0
    audio[:, 0] += labels * 2.0
    data = port_pipeline.DatasetArrays(
        video=video, audio=audio,
        pad_mask=np.arange(t)[None, :] >= lengths[:, None],
        labels=labels, lengths=lengths, keys=[str(i) for i in range(n)],
        max_chunks=t)
    tr, va, te = port_pipeline.stratified_splits(labels, seed=42)
    return data, port_pipeline.DataSplits(
        tr, va, te, port_pipeline.balanced_class_weights(labels[tr]))


def _soft(n):
    return np.random.default_rng(3).dirichlet(np.ones(6), size=n).astype(np.float32)


def _chunks():
    return (np.random.default_rng(0).random((13, 8, 32, 32, 3)) * 255).astype(np.uint8)


def _waves():
    rng = np.random.default_rng(0)
    return [rng.normal(size=(8000 + 321 * i,)).astype(np.float32)
            for i in range(13)]


# -- rank bodies (also run in this process for the single-device side) --------

def _counting(fn):
    """``fn()`` with every torch.distributed collective counted by name."""
    names = [n for n in ("all_gather", "all_gather_into_tensor", "all_reduce",
                         "broadcast", "reduce_scatter", "reduce_scatter_tensor",
                         "all_to_all", "barrier", "gather", "scatter", "reduce")
             if hasattr(dist, n)]
    saved = {n: getattr(dist, n) for n in names}
    counts: dict = {}

    def wrap(name, f):
        def counted(*args, **kwargs):
            counts[name] = counts.get(name, 0) + 1
            return f(*args, **kwargs)
        return counted

    for n, f in saved.items():
        setattr(dist, n, wrap(n, f))
    try:
        return fn(), counts
    finally:
        for n, f in saved.items():
            setattr(dist, n, f)


def case_video(mesh_cfg):
    mesh = None if mesh_cfg is None else create_mesh(mesh_cfg)
    ext = VideoFeatureExtractor(port_config.ViViTConfig(**TINY_V), device=CPU,
                                device_batch=6, mesh=mesh)
    plain, counts = _counting(lambda: ext.embed_chunks(_chunks()))
    piped = ext.embed_chunks(_chunks(), pipeline=True)
    return {"device_batch": ext.device_batch, "feats": plain, "piped": piped,
            "collectives": counts}


def case_audio(mesh_cfg):
    mesh = None if mesh_cfg is None else create_mesh(mesh_cfg)
    emb = AudioEmbedder(port_config.Wav2Vec2Config(**TINY_A), device=CPU,
                        mesh=mesh)
    feats, counts = _counting(lambda: emb.embed_batch(_waves()))
    return {"feats": feats, "collectives": counts}


def case_train(mesh_cfg, model_kw, train_kw, soft=False, fused=False,
               resume_dir=None):
    """``train_model`` on ``_dataset()`` with the key schedule of JAX's
    fused trainer (``fused``) or of its epoch loop; ``resume_dir``: the
    mid-run checkpoints to continue from."""
    data, splits = _dataset()
    out = port_loop.train_model(
        data, splits, port_config.ModelConfig(**model_kw),
        port_config.TrainConfig(**train_kw), batch_size=BATCH,
        verbose=False, device=CPU, mesh_cfg=mesh_cfg,
        soft_targets=_soft(len(data.labels)) if soft else None,
        resume_dir=resume_dir, fused=fused)
    return {"rows": out.results, "mesh": out.hyperparameters["mesh"],
            "best_epoch": out.best_epoch, "confusion": out.confusion,
            "final": {k: v.numpy() for k, v in out.final_params.items()},
            "paths": out.results_path}


def case_step(mesh_cfg):
    """A dp×tp forward (eval mode) and one training step with dropout on,
    on an 8-row global batch: the logits, the global loss and the clipped
    gradients, gathered into the single-device layout."""
    cfg = port_config.ModelConfig(**SMALL)
    rng = np.random.default_rng(11)
    data = {"video": torch.from_numpy(rng.normal(size=(8, 3, 768)).astype(np.float32)),
            "audio": torch.from_numpy(rng.normal(size=(8, 1024)).astype(np.float32)),
            "pad_mask": torch.from_numpy(np.arange(3)[None, :] >= rng.integers(
                1, 4, size=(8, 1))),
            "labels": torch.from_numpy(rng.integers(0, 6, size=(8,)))}
    model = init_fusion(cfg, device=CPU, seed=0)
    mesh = None
    rows = slice(None)
    if mesh_cfg is not None:
        mesh = create_mesh(mesh_cfg)
        shard_params(model, mesh)
        rows = mesh.batch_rows(8)
    with torch.no_grad():
        logits = model(data["video"][rows], data["audio"][rows],
                       data["pad_mask"][rows])[1]
    if mesh is not None:
        logits = mesh.all_gather_rows(logits)
    tcfg = port_config.TrainConfig(lr=0.0)
    optimizer = port_loop.make_optimizer(model, tcfg)
    model.train()
    rand = KeySchedule([1], "loop", cfg, tcfg, 8, 3, CPU).draw()
    loss = port_loop.train_step(
        model, optimizer, data, torch.arange(8), port_loop.StepDraws(),
        torch.linspace(0.5, 1.5, 6), tcfg, rand, mesh=mesh)
    if mesh is not None:
        mesh.all_reduce(loss)
    grads = gather_params({n: p.grad for n, p in model.named_parameters()}, mesh)
    return {"logits": logits.numpy(), "loss": float(loss),
            "grads": {k: v.numpy() for k, v in grads.items()},
            "shard_shapes": {n: tuple(p.shape) for n, p in model.named_parameters()}}


def case_mesh_errors():
    """create_mesh's refusals in a world of 4, and a device the gloo group
    cannot serve."""
    out = []
    for cfg in (MeshConfig(model_parallel=3), MeshConfig(data_parallel=4, model_parallel=2),
                MeshConfig(data_parallel=3)):
        try:
            create_mesh(cfg)
            out.append(None)
        except ValueError as e:
            out.append(str(e))
    mesh = create_mesh(MeshConfig())
    try:
        mesh.check_device(torch.device("cuda"))
        out.append(None)
    except RuntimeError as e:
        out.append(str(e))
    return out


def case_scaling():
    """Both probes at small sizes, the trainer's at the narrow f32 model in
    place of the full-width bf16 one (whose best score moves by ~1e-3
    between batch splits on the CPU)."""
    full = port_config.ModelConfig
    port_config.ModelConfig = lambda max_seq_len: full(**{**SMALL,
                                                           "max_seq_len": max_seq_len})
    try:
        return {"extract": scaling.measure_extract_scaling(
                    2, reps=1, per_device_batch=2, device=CPU),
                "train": scaling.measure_train_scaling(
                    2, reps=1, epochs=2, batch=64, n_samples=256, device=CPU)}
    finally:
        port_config.ModelConfig = full


def case_dryrun():
    from mmer_tpu_torch.parallel.dryrun import _dryrun_body

    return _dryrun_body(dist.get_world_size(), "cpu")


def _cut(root, tag):
    """``TRAIN`` stopped after epoch 2 of 3, a checkpoint every epoch under
    ``root/tag/checkpoints``."""
    return {**TRAIN, "num_epochs": 2, "checkpoint_every": 1,
            "output_dir": f"{root}/{tag}"}


def _resume(mesh_cfg, root, tag, into):
    """The case that continues ``root/tag``'s checkpoints to epoch 3."""
    return (case_train, (mesh_cfg, SMALL, {**TRAIN, "output_dir": f"{root}/{into}"},
                         False, False, f"{root}/{tag}/checkpoints"))


def _run_cases(cases):
    """A world's body: every case, in order, on this rank."""
    return [fn(*args) for fn, args in cases]


# -- the worlds and the JAX side ------------------------------------------------------

@pytest.fixture(scope="module")
def c5_root(tmp_path_factory):
    """Where the mid-run checkpoints of the resume cases live: a
    single-device run cut after epoch 2 is written before the worlds start,
    each world's cut runs under ``dp2`` and ``tp``."""
    root = str(tmp_path_factory.mktemp("c5"))
    case_train(None, SMALL, _cut(root, "single"))
    return root


@pytest.fixture(scope="module")
def worlds(c5_root):
    dp = MeshConfig()
    tp = MeshConfig(model_parallel=2)
    w2 = [(case_video, (dp,)), (case_audio, (dp,)),
          (case_train, (dp, SMALL, TRAIN)),
          (case_train, (dp, SMALL, {**TRAIN, **OPT_INS}, True, True)),
          (case_train, (dp, {**SMALL, "norm": "batchnorm"}, TRAIN)),
          (case_train, (dp, JAX_MODEL, TRAIN, False, True)),
          (case_scaling, ()),
          (case_train, (dp, JAX_BN, TRAIN)),
          (case_train, (dp, SMALL, _cut(c5_root, "dp2"))),
          _resume(dp, c5_root, "dp2", "dp2_resumed"),
          _resume(dp, c5_root, "single", "single_on_dp2")]
    w4 = [(case_video, (dp,)), (case_audio, (dp,)),
          (case_train, (dp, SMALL, TRAIN)),
          (case_train, (dp, JAX_MODEL, TRAIN, False, True)),
          (case_train, (tp, SMALL, TRAIN)),
          (case_train, (tp, SMALL, {**TRAIN, **OPT_INS}, True, True)),
          (case_train, (tp, JAX_MODEL, {**TRAIN, **DISTILL}, True, True)),
          (case_step, (tp,)), (case_mesh_errors, ()), (case_dryrun, ()),
          (case_train, (tp, SMALL, _cut(c5_root, "tp"))),
          _resume(tp, c5_root, "tp", "tp_resumed"),
          _resume(tp, c5_root, "single", "single_on_tp")]
    pool = cf.ThreadPoolExecutor(2)
    # One thread a rank: the tier-1 run shares the host with other workers.
    futures = {2: pool.submit(spawn_cpu_world, _run_cases, 2, (w2,),
                              timeout_s=300, threads=1),
               4: pool.submit(spawn_cpu_world, _run_cases, 4, (w4,),
                              timeout_s=300, threads=1)}
    pool.shutdown(wait=False)
    results = {}

    def get(world, i, rank=0):
        if world not in results:
            results[world] = futures[world].result(timeout=330)
        return results[world][rank][i]

    yield get
    for f in futures.values():
        f.result(timeout=330)


@pytest.fixture(scope="module")
def single():
    """The port's single-device runs, in this process (no process group)."""
    return {"video": case_video(None), "audio": case_audio(None),
            "small": case_train(None, SMALL, TRAIN),
            "opt_ins": case_train(None, SMALL, {**TRAIN, **OPT_INS}, True, True),
            "bn": case_train(None, {**SMALL, "norm": "batchnorm"}, TRAIN),
            "step": case_step(None)}


@pytest.fixture(scope="module")
def jax_runs():
    """The JAX package's trainers on its 8-device CPU mesh: the fused one as
    tests/test_fused_multichip.py runs it, dp8 and dp4×tp2 with
    distillation; the epoch-loop one (the only one that takes BatchNorm)
    at dp8 on the BatchNorm model."""
    import mmer_tpu.config as jc
    from mmer_tpu.train.loop import train_model

    from tests.conftest import make_tiny_dataset

    data, splits = make_tiny_dataset(seed=7, n=128, separable=True)

    def run(mesh_cfg, extra):
        out = train_model(data, splits, jc.ModelConfig(**JAX_MODEL),
                          jc.TrainConfig(**TRAIN, **extra), batch_size=BATCH,
                          mesh_cfg=mesh_cfg, verbose=False, fused=True,
                          soft_targets=_soft(128) if extra else None)
        return out

    return {"dp8": run(jc.MeshConfig(), {}),
            "dp4tp2": run(jc.MeshConfig(model_parallel=2), DISTILL),
            "bn_dp8": train_model(data, splits, jc.ModelConfig(**JAX_BN),
                                  jc.TrainConfig(**TRAIN), batch_size=BATCH,
                                  mesh_cfg=jc.MeshConfig(), verbose=False,
                                  fused=False)}


def _traj(out):
    return np.asarray([[r["train_loss"], r["val_loss"], r["test_acc"]]
                       for r in out["rows"]])


def _rows_match(got_rows, want_rows, loss_rtol=1e-4):
    """tests/test_torch_train.py's bounds: losses within 1e-4 relative, the
    metrics (from equal confusion matrices) equal."""
    assert len(got_rows) == len(want_rows)
    for g, w in zip(got_rows, want_rows):
        for key in w:
            if key == "learning_rate":
                continue
            if key.endswith("_loss"):
                np.testing.assert_allclose(g[key], w[key], rtol=loss_rtol, err_msg=key)
            else:
                np.testing.assert_allclose(g[key], w[key], rtol=1e-6, err_msg=key)


# -- mesh layout and sharding rules, in this process ------------------------------

def test_mesh_without_a_process_group_is_one_rank_and_silent():
    mesh = create_mesh(MeshConfig())
    assert (mesh.dp, mesh.mp, mesh.active, mesh.shape) == (1, 1, False,
                                                            {"data": 1, "model": 1})
    x = torch.arange(6.0).reshape(3, 2)
    (out, _), counts = _counting(lambda: (mesh.all_gather_rows(x), mesh.all_reduce(x)))
    assert out is x and counts == {}
    assert pad_to_multiple(13, 4) == 16 and pad_to_multiple(16, 4) == 16


@pytest.mark.parametrize("cfg, msg", [
    (MeshConfig(model_parallel=2), "not divisible by model_parallel=2"),
    (MeshConfig(data_parallel=2), "needs more than 1 devices")])
def test_create_mesh_keeps_jax_errors(cfg, msg):
    """JAX's two refusals (``mmer_tpu/core/mesh.py:33-37``) on one device."""
    import jax
    import mmer_tpu.config as jc
    import mmer_tpu.core.mesh as jax_mesh

    with pytest.raises(ValueError, match=msg):
        create_mesh(cfg)
    with pytest.raises(ValueError, match=msg):
        jax_mesh.create_mesh(jc.MeshConfig(**dataclasses.asdict(cfg)),
                             devices=jax.devices()[:1])


def test_fusion_param_spec_pairs_like_jax():
    """The Megatron pairing over the port's names: q/k/v and ffn_in split on
    their output rows (biases with them), out and ffn_out on their input
    columns, the rest replicated; JAX's specs name the same tensors (its
    q/k/v biases stay replicated, the port's follow their heads)."""
    import jax
    import mmer_tpu.config as jc
    from mmer_tpu.models.fusion import MultimodalEmotionModel as JaxFusion
    from mmer_tpu.parallel.sharding import fusion_param_spec as jax_spec

    model = init_fusion(port_config.ModelConfig(**SMALL), device=CPU)
    got = {n: fusion_param_spec(n, p) for n, p in model.state_dict().items()}
    split = {n: d for n, d in got.items() if d is not None}
    assert split == {
        **{f"fusion.layers.{i}.self_attn.{m}.{leaf}": 0 for i in range(2)
           for m in ("query", "key", "value") for leaf in ("weight", "bias")},
        **{f"fusion.layers.{i}.self_attn.out.weight": 1 for i in range(2)},
        **{f"fusion.layers.{i}.ffn_in.{leaf}": 0 for i in range(2)
           for leaf in ("weight", "bias")},
        **{f"fusion.layers.{i}.ffn_out.weight": 1 for i in range(2)}}
    params = JaxFusion(jc.ModelConfig(**SMALL)).init(
        {"params": jax.random.PRNGKey(0)}, np.zeros((1, 3, 768), np.float32),
        np.zeros((1, 1024), np.float32), np.zeros((1, 3), bool))["params"]
    jax_split = set()
    for path, leaf in jax.tree_util.tree_flatten_with_path(params)[0]:
        if any(a is not None for a in jax_spec(path, leaf)):
            names = [str(getattr(p, "key", p)) for p in path]
            jax_split.add(re.sub(r"layer_(\d+)", r"layers.\1",
                                 ".".join(names[1:-1])))
    port_split = {n.rsplit(".", 1)[0].replace("fusion.", "") for n in split}
    assert jax_split == port_split


def test_scaling_does_not_swallow_a_failed_leg(monkeypatch):
    """Unlike the JAX module's main, a failing train leg propagates."""
    def boom(*args, **kwargs):
        raise AssertionError("train leg diverged")

    monkeypatch.setattr(scaling, "measure_train_scaling", boom)
    with pytest.raises(AssertionError, match="diverged"):
        scaling.run(1, "cpu", 1, 1, True, False, 2)


# -- against the JAX package's mesh runs --------------------------------------------

@pytest.mark.parametrize("world, index", [(2, 5), (4, 3)])
def test_dp_train_model_matches_jax_dp8(worlds, jax_runs, world, index):
    """The port's dp2 and dp4 runs against ``train_model(fused=True,
    mesh_cfg=MeshConfig())`` on JAX's 8 devices, the port drawing the fused
    trainer's key schedule, dropout on: the rows at test_torch_train.py's
    bounds."""
    want = jax_runs["dp8"]
    got = worlds(world, index)
    _rows_match(got["rows"], want.results)
    assert got["best_epoch"] == want.best_epoch
    np.testing.assert_array_equal(got["confusion"], want.confusion)


def test_dp_tp_distill_matches_jax_dp4_tp2(worlds, jax_runs):
    """dp2×tp2 with distillation against JAX's dp4×tp2 distilled run."""
    want = jax_runs["dp4tp2"]
    got = worlds(4, 6)
    _rows_match(got["rows"], want.results)
    assert got["best_epoch"] == want.best_epoch
    assert want.hyperparameters["mesh"] == {"data": 4, "model": 2}
    assert got["mesh"] == {"data": 2, "model": 2}


def test_dp_batchnorm_matches_jax_dp8(worlds, jax_runs):
    """The port's dp2 BatchNorm run (global-batch statistics) against JAX's
    epoch-loop trainer on its 8 devices, whose sharded step XLA computes
    with the global batch's statistics (``mmer_tpu/train/loop.py:486-566``):
    the port drawing the epoch loop's key schedule, dropout on, the rows at
    test_torch_train.py's bounds and the confusion matrices equal."""
    want = jax_runs["bn_dp8"]
    got = worlds(2, 7)
    assert want.hyperparameters["mesh"] == {"data": 8, "model": 1}
    _rows_match(got["rows"], want.results)
    assert got["best_epoch"] == want.best_epoch
    np.testing.assert_array_equal(got["confusion"], want.confusion)


def test_sharded_extraction_matches_jax_mesh(worlds):
    """The port's four-rank features against the JAX extractors on the
    8-device mesh (plain XLA route), at tests/test_torch_extract.py's
    port-against-JAX bounds."""
    import mmer_tpu.config as jc
    from mmer_tpu.core.mesh import create_mesh as jax_create_mesh
    from mmer_tpu.models.wav2vec2 import AudioEmbedder as JaxAudioEmbedder
    from mmer_tpu.preprocess.extract import VideoFeatureExtractor as JaxVideo

    mesh = jax_create_mesh(jc.MeshConfig())
    video = JaxVideo(jc.ViViTConfig(**TINY_V), device_batch=8, use_flash=False,
                     mesh=mesh).embed_chunks(_chunks())
    np.testing.assert_allclose(worlds(4, 0)["feats"], video, atol=1e-4, rtol=1e-4)
    audio = JaxAudioEmbedder(jc.Wav2Vec2Config(**TINY_A), mesh=mesh).embed_batch(_waves())
    np.testing.assert_allclose(worlds(4, 1)["feats"], audio, atol=2e-5, rtol=1e-4)


# -- against the port's single-device runs -------------------------------------------

@pytest.mark.parametrize("world", [2, 4])
def test_sharded_video_matches_single_device(worlds, single, world):
    """13 chunks, device_batch 6 (rounded up to 8 on four ranks): the
    features within 1e-5 of one device's, the pipelined call equal to the
    serial one, every rank with the same rows."""
    got = worlds(world, 0)
    assert got["device_batch"] == pad_to_multiple(6, world)
    assert got["feats"].shape == (13, 64)
    np.testing.assert_allclose(got["feats"], single["video"]["feats"],
                               rtol=1e-5, atol=1e-5)
    np.testing.assert_array_equal(got["piped"], got["feats"])
    for rank in range(1, world):
        np.testing.assert_array_equal(worlds(world, 0, rank)["feats"], got["feats"])


@pytest.mark.parametrize("world", [2, 4])
def test_sharded_extraction_issues_one_all_gather_a_block(worlds, world):
    """The port's counterpart of test_sharded_extraction_programs_have_no_collectives:
    each device batch costs one all-gather and nothing else (video: 13
    chunks in blocks of 6 or 8; audio: one padded forward)."""
    blocks = -(-13 // pad_to_multiple(6, world))
    assert worlds(world, 0)["collectives"] == {"all_gather": blocks}
    assert worlds(world, 1)["collectives"] == {"all_gather": 1}


@pytest.mark.parametrize("world", [2, 4])
def test_sharded_audio_matches_single_device(worlds, single, world):
    """13 waveforms, padded to a batch of 16 and sliced back: within 1e-5
    of one device's embeddings."""
    got = worlds(world, 1)["feats"]
    assert got.shape == (13, 64)
    np.testing.assert_allclose(got, single["audio"]["feats"], rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("world, index, ref", [
    (2, 2, "small"), (2, 3, "opt_ins"), (2, 4, "bn"),
    (4, 2, "small"), (4, 4, "small"), (4, 5, "opt_ins")])
def test_sharded_train_model_matches_single_device(worlds, single, world, index, ref):
    """dp2, dp4 and dp2×tp2 trajectories against one device's, dropout on
    and every draw shared (the masks drawn at full width and sliced):
    plain, with EMA + mixup + modality dropout + distillation, and a
    BatchNorm model (global-batch statistics); every rank the same rows,
    the final parameters gathered into the single-device layout."""
    got, want = worlds(world, index), single[ref]
    np.testing.assert_allclose(_traj(got), _traj(want), **TRAJ)
    assert got["best_epoch"] == want["best_epoch"]
    np.testing.assert_array_equal(got["confusion"], want["confusion"])
    assert got["final"].keys() == want["final"].keys()
    for name, value in want["final"].items():
        assert got["final"][name].shape == value.shape
        np.testing.assert_allclose(got["final"][name], value, rtol=5e-3, atol=5e-4,
                                   err_msg=name)
    for rank in range(1, world):
        assert worlds(world, index, rank)["rows"] == got["rows"]
        assert worlds(world, index, rank)["paths"] is None


@pytest.mark.parametrize("world, full, cut, resumed", [(2, 2, 8, 9), (4, 4, 10, 11)])
def test_mesh_resume_equals_uninterrupted_run(worlds, world, full, cut, resumed):
    """C5: a dp2 and a dp2×tp2 run cut after epoch 2 and resumed from its
    checkpoint repeats epoch 3 of the uninterrupted run on the same mesh,
    rows and final weights bit for bit, on every rank."""
    want, got = worlds(world, full), worlds(world, resumed)
    assert [r["epoch"] for r in worlds(world, cut)["rows"]] == [1, 2]
    assert worlds(world, cut)["rows"] == want["rows"][:2]
    assert [r["epoch"] for r in got["rows"]] == [3]
    assert got["rows"] == want["rows"][2:]
    assert got["best_epoch"] == want["best_epoch"]
    np.testing.assert_array_equal(got["confusion"], want["confusion"])
    for name, value in want["final"].items():
        np.testing.assert_array_equal(got["final"][name], value, err_msg=name)
    for rank in range(1, world):
        assert worlds(world, resumed, rank)["rows"] == got["rows"]


def _matches_single(got, want):
    np.testing.assert_allclose(_traj(got), _traj(want)[2:], **TRAJ)
    assert got["best_epoch"] == want["best_epoch"]
    for name, value in want["final"].items():
        np.testing.assert_allclose(got["final"][name], value, rtol=5e-3, atol=5e-4,
                                   err_msg=name)


@pytest.mark.parametrize("world, index", [(2, 10), (4, 12)])
def test_single_device_checkpoint_resumes_on_a_mesh(worlds, single, world, index):
    """A single-device run's epoch-2 checkpoint continued over dp2 and
    dp2×tp2 (each rank takes its shard of the weights and of Adam's moments)
    follows the single-device run's epoch 3 to float tolerance."""
    _matches_single(worlds(world, index), single["small"])


@pytest.mark.parametrize("world, tag", [(2, "dp2"), (4, "tp")])
def test_mesh_checkpoint_resumes_single_device(worlds, single, c5_root, world, tag):
    """A dp2 and a dp2×tp2 run's epoch-2 checkpoint holds the single-device
    layout (weights, best weights and Adam's moments at full shape) and
    continues on one device as the single-device run does."""
    worlds(world, 0)                        # the world has written its files
    path = f"{c5_root}/{tag}/checkpoints/state_000002.pth"
    payload = torch.load(path, weights_only=True)
    shapes = {k: v.shape for k, v in single["small"]["final"].items()}
    assert {k: tuple(v.shape) for k, v in payload["model"].items()} == shapes
    assert {k: tuple(v.shape) for k, v in payload["best"].items()} == shapes
    params = [n for n, _ in init_fusion(port_config.ModelConfig(**SMALL),
                                        device=CPU).named_parameters()]
    assert len(payload["optimizer"]["state"]) == len(params)
    for idx, st in payload["optimizer"]["state"].items():
        assert tuple(st["exp_avg"].shape) == shapes[params[idx]]
        assert tuple(st["exp_avg_sq"].shape) == shapes[params[idx]]
    got = case_train(None, SMALL, {**TRAIN, "output_dir": f"{c5_root}/{tag}_on_one"},
                     resume_dir=f"{c5_root}/{tag}/checkpoints")
    _matches_single(got, single["small"])


@pytest.mark.parametrize("world, index", [(2, 2), (4, 2), (4, 4)])
def test_run_log_names_the_mesh(worlds, world, index):
    """JAX's ``"mesh"`` key: {"data": dp, "model": mp}."""
    mp = 2 if index == 4 else 1
    assert worlds(world, index)["mesh"] == {"data": world // mp, "model": mp}


def test_dp_tp_forward_and_step_match_single_device(worlds, single):
    """dp2×tp2: logits, the step's loss and its clipped gradients (gathered)
    within 1e-5 of one device's; each rank holds half the heads and FFN
    columns."""
    got, want = worlds(4, 7), single["step"]
    np.testing.assert_allclose(got["logits"], want["logits"], rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(got["loss"], want["loss"], rtol=1e-5)
    for name, g in want["grads"].items():
        np.testing.assert_allclose(got["grads"][name], g, rtol=1e-4, atol=1e-6,
                                   err_msg=name)
    shapes = got["shard_shapes"]
    assert shapes["fusion.layers.0.self_attn.query.weight"] == (16, 32)
    assert shapes["fusion.layers.0.self_attn.out.weight"] == (32, 16)
    assert shapes["fusion.layers.0.ffn_in.bias"] == (32,)
    assert shapes["fusion.layers.0.ffn_out.weight"] == (32, 32)


# -- the mesh's refusals, scaling and the dry run in a world --------------------------

def test_create_mesh_errors_in_a_world(worlds):
    got = worlds(4, 8)
    assert "4 devices not divisible by model_parallel=3" in got[0]
    assert "mesh 4x2 needs more than 4 devices" in got[1]
    assert "leaves ranks of a world of 4 idle" in got[2]
    assert "a gloo process group cannot serve cuda" in got[3]


def test_scaling_smoke_at_two_ranks(worlds):
    """measure_extract_scaling and measure_train_scaling at n = 2 on gloo
    ranks: JAX's keys, mesh outputs equal to single-device ones."""
    got = worlds(2, 6)
    for leg in ("video", "audio"):
        r = got["extract"][leg]
        assert r["max_abs_err"] <= 1e-5
        assert {"efficiency", "weak_efficiency", "weak_efficiency_raw",
                "t_single_s", "t_sharded_s", "global_batch"} <= set(r)
    t = got["train"]
    assert {"efficiency", "efficiency_raw", "best_score_abs_diff",
            "t_single_s", "t_sharded_s"} <= set(t)
    assert t["best_score_abs_diff"] <= 1e-3 * 2
    assert "t_single_s" not in worlds(2, 6, rank=1)["train"]


def test_dryrun_at_four_ranks(worlds):
    lines = worlds(4, 9)
    assert lines[0].startswith("dryrun_multichip OK: mesh={'data': 2, 'model': 2}")
    assert lines[1].startswith("dryrun train_model OK: 2 epochs over dp2xtp2")
    assert lines[2].startswith("dryrun extract fan-out OK: dp4")


def test_dryrun_refuses_the_cpu_unless_asked(monkeypatch):
    """The dry run's entry point runs on the cards (under torchrun) unless
    the caller passes --device cpu."""
    from mmer_tpu_torch.parallel import dryrun

    monkeypatch.delenv("WORLD_SIZE", raising=False)
    with pytest.raises(SystemExit, match="pass --device cpu"):
        dryrun.main([])


def test_spawned_world_reports_a_failing_rank():
    """A rank that raises stops its world and the caller sees its error."""
    with pytest.raises(RuntimeError, match="need a world of 3 ranks"):
        spawn_cpu_world(scaling.measure_extract_scaling, 2, (3,), timeout_s=60)
