"""The port's beyond-memory training path and device probe against the JAX
package, on the CPU: the bulk ``.npy`` loader (``csrc/npy_loader.cpp`` byte
for byte the JAX package's ``native/npy_loader.cpp``, its arrays bit for bit
numpy's, f16 subnormals included), ``load_feature_arrays``' native route,
``StreamingFeatureDataset`` batch for batch against JAX's, ``train_streaming``
row for row against JAX's at the default dropout (the port draws JAX's
masks), and ``core.check`` refusing to run
without CUDA.  Loss tolerances are ``tests/test_torch_train.py``'s (1e-4
relative, float32 summation order).
"""

from __future__ import annotations

import os

import numpy as np
import pytest
import torch

import mmer_tpu.config as jax_config
import mmer_tpu.data.catalog as jax_catalog
import mmer_tpu.data.streaming as jax_streaming
import mmer_tpu.train.streaming as jax_train_streaming
import mmer_tpu_torch.config as port_config
import mmer_tpu_torch.data.catalog as port_catalog
import mmer_tpu_torch.data.native_loader as nl
import mmer_tpu_torch.data.pipeline as port_pipeline
import mmer_tpu_torch.data.streaming as port_streaming
import mmer_tpu_torch.train.streaming as port_train_streaming
from mmer_tpu_torch.core import check as port_check
from mmer_tpu_torch.models.convert import fusion_from_flax
from tests.test_torch_train import assert_weights_match

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
MODEL_KW = dict(max_seq_len=6, fusion_layers=1, fusion_heads=2, fused_dim=32,
                fusion_ffn_dim=64, classifier_hidden_dim=32,
                compute_dtype="float32", fusion_dropout=0.0,
                classifier_dropout=0.0)


# -- the native loader ------------------------------------------------------------------

def test_loader_source_is_the_jax_packages_byte_for_byte():
    with open(os.path.join(REPO, "native", "npy_loader.cpp"), "rb") as f:
        theirs = f.read()
    with open(os.path.join(REPO, "mmer_tpu_torch", "csrc", "npy_loader.cpp"),
              "rb") as f:
        assert f.read() == theirs


def test_f32_batch_matches_numpy(tmp_path):
    rng = np.random.default_rng(0)
    paths, arrays = [], []
    for i, t in enumerate((1, 3, 7)):
        a = rng.normal(size=(t, 16)).astype(np.float32)
        paths.append(str(tmp_path / f"v{i}.npy"))
        np.save(paths[-1], a)
        arrays.append(a)
    out, rows = nl.load_f32_batch(paths, cols=16, max_rows=8)
    assert list(rows) == [1, 3, 7]
    for i, a in enumerate(arrays):
        np.testing.assert_array_equal(out[i, :rows[i]], a)
        np.testing.assert_array_equal(out[i, rows[i]:], 0.0)


def test_f16_bits_equal_numpy_including_subnormals(tmp_path):
    """Every f16 bit pattern once: the float32 bits equal numpy's conversion
    (NaNs as NaNs)."""
    all16 = np.arange(65536, dtype=np.uint16).view(np.float16)
    path = str(tmp_path / "all.npy")
    np.save(path, all16)
    out, fails = nl.load_f16_vec_batch([path], 65536)
    assert fails == 0
    want = all16.astype(np.float32)
    nan = np.isnan(want)
    np.testing.assert_array_equal(np.isnan(out[0]), nan)
    np.testing.assert_array_equal(out[0][~nan].view(np.uint32),
                                  want[~nan].view(np.uint32))
    sub = (all16.view(np.uint16) & 0x7C00) == 0
    assert sub.sum() == 2048 and (out[0][sub] != 0).sum() == 2046


def test_contract_violations_and_oversize_are_reported(tmp_path):
    np.save(tmp_path / "wrong_cols.npy", np.zeros((2, 8), np.float32))
    np.save(tmp_path / "wrong_dtype.npy", np.zeros((2, 16), np.float16))
    np.save(tmp_path / "good.npy", np.ones((2, 16), np.float32))
    np.save(tmp_path / "big.npy", np.ones((10, 16), np.float32))
    out, rows = nl.load_f32_batch(
        [str(tmp_path / n) for n in ("wrong_cols.npy", "wrong_dtype.npy",
                                     "good.npy", "missing.npy", "big.npy")],
        cols=16, max_rows=4)
    assert list(rows) == [-1, -1, 2, -1, 10]
    np.testing.assert_array_equal(out[2, :2], 1.0)
    np.testing.assert_array_equal(out[4], 1.0)


def test_native_route_equals_numpy_route_bit_for_bit(synthetic_feature_dirs):
    vdir, adir = synthetic_feature_dirs
    catalog = port_catalog.build_catalog(vdir, adir, "key")
    v1, a1 = port_pipeline.load_feature_arrays(catalog, use_native=True)
    v2, a2 = port_pipeline.load_feature_arrays(catalog, use_native=False)
    assert len(v1) == len(v2) == len(catalog)
    for x, y in zip(v1, v2):
        assert x.dtype == y.dtype == np.float32
        np.testing.assert_array_equal(x.view(np.uint32), y.view(np.uint32))
    np.testing.assert_array_equal(a1.view(np.uint32), a2.view(np.uint32))


def test_a_bad_artifact_goes_through_numpy_for_its_error(tmp_path):
    vdir, adir = tmp_path / "v", tmp_path / "a"
    vdir.mkdir()
    adir.mkdir()
    np.save(vdir / "1001_IEA_ANG_XX_faces_mp4_features.npy",
            np.zeros((2, 700), np.float32))
    np.save(adir / "1001_IEA_ANG_XX_voice_mp4_features.npy",
            np.zeros((1024,), np.float16))
    catalog = port_catalog.build_catalog(str(vdir), str(adir), "key")
    with pytest.raises(ValueError, match=r"expected \(T, 768\), got \(2, 700\)"):
        port_pipeline.load_feature_arrays(catalog)


def test_a_failed_build_raises_and_never_falls_back(monkeypatch, synthetic_feature_dirs):
    """No compiler, no library: the native route raises instead of reading
    through numpy."""
    import mmer_tpu_torch.ops._build as build

    def no_compiler(name):
        raise RuntimeError(f"no C++ compiler: csrc/{name}.cpp cannot be built")

    monkeypatch.setattr(build, "host_library", no_compiler)
    catalog = port_catalog.build_catalog(*synthetic_feature_dirs, "key")
    with pytest.raises(RuntimeError, match="no C\\+\\+ compiler"):
        port_pipeline.load_feature_arrays(catalog)
    ds = port_streaming.StreamingFeatureDataset(catalog, 8, max_chunks=5)
    with pytest.raises(RuntimeError, match="no C\\+\\+ compiler"):
        next(ds.epoch(0))


# -- the streaming dataset and trainer ----------------------------------------------------

def _catalogs(dirs):
    vdir, adir = dirs
    return (jax_catalog.build_catalog(vdir, adir, "key"),
            port_catalog.build_catalog(vdir, adir, "key"))


@pytest.mark.parametrize("with_stats", [False, True])
def test_streaming_batches_equal_jax_batch_for_batch(synthetic_feature_dirs, with_stats):
    """Two epochs of 16-row batches (a ragged tail), with and without
    normalisation statistics: every array equal to the JAX stream's
    ``epoch(device_put=False)``, the native loader reading every batch."""
    jax_cat, port_cat = _catalogs(synthetic_feature_dirs)
    stats = None
    if with_stats:
        rng = np.random.default_rng(1)
        stats = {"video_mean": rng.normal(size=768).astype(np.float32),
                 "video_std": rng.uniform(0.5, 2, size=768).astype(np.float32),
                 "audio_mean": rng.normal(size=1024).astype(np.float32),
                 "audio_std": rng.uniform(0.5, 2, size=1024).astype(np.float32)}
    theirs = jax_streaming.StreamingFeatureDataset(jax_cat, 16, max_chunks=4,
                                                   seed=3, norm_stats=stats)
    ours = port_streaming.StreamingFeatureDataset(port_cat, 16, max_chunks=4,
                                                  seed=3, norm_stats=stats)
    assert len(ours) == len(theirs)
    n = 0
    for epoch in (0, 1):
        want = list(theirs.epoch(epoch, device_put=False))
        got = list(ours.epoch(epoch))
        assert len(got) == len(want)
        for g, w in zip(got, want):
            assert g.keys() == w.keys()
            for key in w:
                assert g[key].dtype == w[key].dtype, key
                np.testing.assert_array_equal(g[key], w[key], err_msg=key)
            n += 1
    assert ours.native_batches == n
    assert 0 < float(want[-1]["weight"].sum()) < 16


def test_streaming_to_a_device_gives_the_same_tensors(synthetic_feature_dirs):
    _, port_cat = _catalogs(synthetic_feature_dirs)
    ds = port_streaming.StreamingFeatureDataset(port_cat, 16, max_chunks=5)
    for host, dev in zip(ds.epoch(1), ds.epoch(1, device="cpu")):
        for key, arr in host.items():
            assert isinstance(dev[key], torch.Tensor)
            np.testing.assert_array_equal(dev[key].numpy(), arr)


def test_train_streaming_matches_jax(synthetic_feature_dirs):
    """Three epochs over 60 / 25 samples at dropout 0.1, each side drawing
    its own masks from ``fold_in(PRNGKey(seed), step)``, a plateau cut and
    an early stop inside them: the rows (losses 1e-4 relative, accuracies
    and learning rates equal), the best parameters within
    test_torch_train's final-weight bounds."""
    model_kw = dict(MODEL_KW, fusion_dropout=0.1, classifier_dropout=0.1)
    jax_cat, port_cat = _catalogs(synthetic_feature_dirs)
    train_kw = dict(num_epochs=4, lr=3e-3, patience=2, min_delta=0.5,
                    scheduler_patience=0, scheduler_factor=0.5)
    cw = np.linspace(0.6, 1.4, 6).astype(np.float32)

    def datasets(module, cat):
        return (module.StreamingFeatureDataset(cat[:60], 16, max_chunks=5, seed=1),
                module.StreamingFeatureDataset(cat[60:85], 16, max_chunks=5))

    want = jax_train_streaming.train_streaming(
        *datasets(jax_streaming, jax_cat), jax_config.ModelConfig(**model_kw),
        jax_config.TrainConfig(**train_kw), class_weights=cw, seed=2,
        verbose=False)
    got = port_train_streaming.train_streaming(
        *datasets(port_streaming, port_cat), port_config.ModelConfig(**model_kw),
        port_config.TrainConfig(**train_kw), class_weights=cw, seed=2,
        verbose=False, device="cpu")
    assert 2 <= len(want["results"]) < train_kw["num_epochs"]
    assert min(r["learning_rate"] for r in want["results"]) < train_kw["lr"]
    assert len(got["results"]) == len(want["results"])
    for g, w in zip(got["results"], want["results"]):
        assert g.keys() == w.keys()
        for key in ("train_loss", "val_loss"):
            np.testing.assert_allclose(g[key], w[key], rtol=1e-4, err_msg=key)
        assert g["epoch"] == w["epoch"]
        np.testing.assert_allclose(g["val_acc"], w["val_acc"], rtol=1e-6)
        assert g["learning_rate"] == w["learning_rate"]
    assert_weights_match(got["best_params"],
                         fusion_from_flax(jax_tree_to_numpy(want["best_params"])))


def jax_tree_to_numpy(tree):
    import jax

    return jax.tree_util.tree_map(np.asarray, tree)


def test_train_streaming_inits_from_the_unsplit_key():
    """JAX's streaming trainer inits with PRNGKey(seed) itself: the port's
    first parameters equal that init (train_model's split key differs)."""
    import jax
    import jax.numpy as jnp
    from mmer_tpu.models.fusion import MultimodalEmotionModel as JaxFusion
    from mmer_tpu_torch.models import jax_init
    from mmer_tpu_torch.models.fusion import init_fusion

    cfg = jax_config.ModelConfig(**MODEL_KW)
    params = JaxFusion(cfg).init({"params": jax.random.PRNGKey(5)},
                                 jnp.zeros((1, 5, 768)), jnp.zeros((1, 1024)),
                                 jnp.zeros((1, 5), bool))["params"]
    ours = init_fusion(port_config.ModelConfig(**MODEL_KW), device="cpu", seed=5,
                       key=jax_init.PRNGKey(5)).state_dict()
    for name, value in fusion_from_flax(jax_tree_to_numpy(params)).items():
        np.testing.assert_array_equal(ours[name].numpy(), value.numpy(), err_msg=name)


# -- the device probe ---------------------------------------------------------------------

def test_check_refuses_to_run_without_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(SystemExit, match="is_available"):
        port_check.main()
