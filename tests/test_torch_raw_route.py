"""The port's raw-media training route against the JAX package's and
against its own disk route, on the CPU.

- ``extract_dataset_arrays``: equal to the port's disk route (extract →
  ``.npy`` → ``load_dataset``, the contract of
  ``tests/test_pipeline.py:test_extract_dataset_arrays_matches_disk_path``)
  and to JAX's ``extract_dataset_arrays`` at a tiny f32 config on the JAX
  package's seeded weights (the port draws them without JAX): video within
  1e-4, audio within one float16 step.
- ``train.cli --raw_videos --raw_audio`` trains on the route's arrays.
"""

import wave

import numpy as np
import pytest
import torch

cv2 = pytest.importorskip("cv2")

import mmer_tpu.config as jax_config
import mmer_tpu_torch.config as port_config
import mmer_tpu_torch.preprocess.extract as port_extract
from mmer_tpu.preprocess import extract as jax_extract
from mmer_tpu_torch.data.pipeline import load_dataset
from mmer_tpu_torch.scripts.full_chain import EMOTIONS

from torch_threads import few_threads  # noqa: F401

TINY_V = dict(image_size=(32, 32), patch_size=(16, 16), num_frames=8,
              tubelet_size=4, dim=768, depth=1, heads=2, dim_head=32,
              mlp_dim=64, compute_dtype="float32")
# tests/test_pipeline.py's tiny audio config with two more stride-2 conv
# layers: the 1 s length bucket gives 400 frames a clip, not 1,599, which
# keeps the 1024-wide layers cheap beside the other test workers.
TINY_A = dict(hidden_dim=1024, num_layers=1, num_heads=2, ffn_dim=64,
              conv_dims=(16, 16, 16, 16), conv_strides=(5, 2, 2, 2),
              conv_kernels=(10, 3, 3, 2), num_conv_pos_embeddings=16,
              num_conv_pos_embedding_groups=4, compute_dtype="float32")


# -- the raw-media route -------------------------------------------------------------

@pytest.fixture(scope="module")
def raw_folders(tmp_path_factory):
    """``tests/test_pipeline.py``'s folders: 60 face videos of 8 random
    32x32 frames and 60 0.3 s label tones."""
    root = tmp_path_factory.mktemp("raw_route")
    vdir, adir = root / "videos", root / "audio"
    vdir.mkdir()
    adir.mkdir()
    rng = np.random.default_rng(0)
    sr = 16000
    for actor in range(1001, 1011):
        for emo in EMOTIONS:
            key = f"{actor}_IEO_{emo}_XX"
            w = cv2.VideoWriter(str(vdir / f"{key}_faces.mp4"),
                                cv2.VideoWriter_fourcc(*"mp4v"), 30.0, (32, 32))
            for _ in range(8):
                w.write(rng.integers(0, 255, (32, 32, 3), np.uint8))
            w.release()
            tone = (0.3 * np.sin(2 * np.pi * (200 + 50 * EMOTIONS.index(emo))
                                 * np.arange(4800) / sr)).astype(np.float32)
            with wave.open(str(adir / f"{key}.wav"), "wb") as f:
                f.setnchannels(1)
                f.setsampwidth(2)
                f.setframerate(sr)
                f.writeframes((tone * 32767).astype(np.int16).tobytes())
    return root


@pytest.fixture(scope="module")
def port_raw(raw_folders):
    """The port's raw-media arrays of the folders, and its video extractor."""
    ex = port_extract.VideoFeatureExtractor(port_config.ViViTConfig(**TINY_V),
                                            device="cpu", device_batch=4)
    return port_extract.extract_dataset_arrays(
        str(raw_folders / "videos"), str(raw_folders / "audio"),
        video_extractor=ex, audio_cfg=port_config.Wav2Vec2Config(**TINY_A),
        verbose=False, device="cpu"), ex


def _assert_same_dataset(got, want, video_tol=0.0, audio_ulp=False):
    (gd, gs), (wd, ws) = got, want
    assert list(gd.keys) == list(wd.keys)
    for field in ("labels", "lengths", "pad_mask"):
        np.testing.assert_array_equal(getattr(gd, field), getattr(wd, field))
    assert gd.max_chunks == wd.max_chunks
    if video_tol:
        np.testing.assert_allclose(gd.video, wd.video, rtol=video_tol, atol=video_tol)
    else:
        np.testing.assert_array_equal(gd.video, wd.video)
    if audio_ulp:
        # The z-scored audio of features one float16 step apart: compare the
        # raw f16 embeddings through the stored statistics.
        g = gd.audio * gd.audio_std + gd.audio_mean
        w = wd.audio * wd.audio_std + wd.audio_mean
        step = np.spacing(np.abs(w).astype(np.float16)).astype(np.float32)
        assert np.all(np.abs(g - w) <= step + 1e-6)
    else:
        np.testing.assert_array_equal(gd.audio, wd.audio)
    for a, b in zip((gs.train, gs.val, gs.test, gs.class_weights),
                    (ws.train, ws.val, ws.test, ws.class_weights)):
        np.testing.assert_array_equal(a, b)


def test_extract_dataset_arrays_equals_the_disk_route(raw_folders, port_raw,
                                                      tmp_path):
    (data, splits), ex = port_raw
    assert data.num_samples == 60
    vfeat, afeat = str(tmp_path / "vfeat"), str(tmp_path / "afeat")
    port_extract.extract_video_folder(str(raw_folders / "videos"), vfeat, ex,
                                      verbose=False)
    port_extract.extract_audio_folder(str(raw_folders / "audio"), afeat,
                                      port_config.Wav2Vec2Config(**TINY_A),
                                      verbose=False, device="cpu")
    disk = load_dataset(port_config.DataConfig(video_feat_dir=vfeat,
                                               audio_feat_dir=afeat))
    _assert_same_dataset((data, splits), disk)


def test_extract_dataset_arrays_matches_jax(raw_folders, port_raw):
    got, _ = port_raw
    ex = jax_extract.VideoFeatureExtractor(jax_config.ViViTConfig(**TINY_V),
                                           device_batch=4, use_flash=False)
    want = jax_extract.extract_dataset_arrays(
        str(raw_folders / "videos"), str(raw_folders / "audio"),
        video_extractor=ex, audio_cfg=jax_config.Wav2Vec2Config(**TINY_A),
        verbose=False)
    _assert_same_dataset(got, want, video_tol=1e-4, audio_ulp=True)


def test_dataset_from_feature_maps_needs_a_pair():
    with pytest.raises(FileNotFoundError):
        port_extract.dataset_from_feature_maps(
            {"1001_IEO_NEU_XX": np.zeros((2, 768))}, {"1002_IEO_NEU_XX": np.zeros(1024)})


def test_train_cli_raw_route(raw_folders, port_raw, tmp_path, monkeypatch):
    """The CLI's raw-media flags hand the folders, its data config and
    device to ``extract_dataset_arrays`` (whose arrays the tests above hold;
    here the fixture's run stands in for it) and train on the arrays."""
    from mmer_tpu_torch.train.cli import main

    calls = []

    def route(video_dir, audio_dir, **kw):
        calls.append((video_dir, audio_dir, kw))
        return port_raw[0]

    monkeypatch.setattr(port_extract, "extract_dataset_arrays", route)
    out = main(["--raw_videos", str(raw_folders / "videos"),
                "--raw_audio", str(raw_folders / "audio"), "--device", "cpu",
                "--num_epochs", "2", "--batch_size", "16",
                "--output_dir", str(tmp_path / "runs")])
    (video_dir, audio_dir, kw), = calls
    assert (video_dir, audio_dir) == (str(raw_folders / "videos"),
                                      str(raw_folders / "audio"))
    assert kw["device"] == torch.device("cpu") or kw["device"] == "cpu"
    assert kw["data_cfg"].batch_size == 16
    assert [r["epoch"] for r in out.results] == [1, 2]
    assert out.hyperparameters["max_seq_len"] == 2
    assert all(np.isfinite(r["train_loss"]) for r in out.results)
