"""The PyTorch port's offline extraction path against the JAX package's.

Two parts.  The host code that the port copies instead of importing
(``core/artifacts``, ``preprocess/audio``, ``preprocess/video``) is held to
the originals over parametrised inputs.  The slice as a whole — a folder of
WAV files or of videos → ``.npy`` artifacts through ``iter_*`` /
``extract_*_folder`` / the CLI's ``main`` on ``device="cpu"`` — is held to the
JAX functions on the same files, at tiny float32 configs whose output widths
are the artifact contract's (768, 1024), with the JAX package's seeded params
carried into the port by ``mmer_tpu_torch.models.convert``.
"""

import functools
import os
import wave as wave_mod

import jax
import numpy as np
import pytest
import torch

import mmer_tpu.config as jax_config
import mmer_tpu.core.artifacts as jax_artifacts
import mmer_tpu.preprocess.audio as jax_audio
import mmer_tpu.preprocess.extract as jax_extract
import mmer_tpu.preprocess.video as jax_video
from mmer_tpu.models.wav2vec2 import AudioEmbedder as JaxAudioEmbedder
import mmer_tpu_torch.config as port_config
import mmer_tpu_torch.core.artifacts as port_artifacts
import mmer_tpu_torch.preprocess.audio as port_audio
import mmer_tpu_torch.preprocess.extract as port_extract
import mmer_tpu_torch.preprocess.video as port_video
from mmer_tpu_torch.models.convert import vivit_from_flax, wav2vec2_from_flax
from mmer_tpu_torch.models.wav2vec2 import AudioEmbedder

from torch_threads import few_threads  # noqa: F401

CPU = torch.device("cpu")
SR = 16000
TINY_V = dict(image_size=(32, 32), patch_size=(16, 16), num_frames=8,
              tubelet_size=4, dim=768, depth=1, heads=2, dim_head=32,
              mlp_dim=64, compute_dtype="float32")
TINY_A = dict(hidden_dim=1024, num_layers=1, num_heads=2, ffn_dim=64,
              conv_dims=(16, 16), conv_strides=(5, 2), conv_kernels=(10, 3),
              num_conv_pos_embeddings=16, num_conv_pos_embedding_groups=4,
              chunk_duration_s=0.5, compute_dtype="float32")


def _np_tree(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _write_wav(path, data, sr=SR, width=2, channels=1):
    """``data``: float in [-1, 1), (n,) or (n, channels)."""
    if width == 2:
        raw = (data * 32767).astype(np.int16)
    elif width == 4:
        raw = (data * 2147483647).astype(np.int32)
    elif width == 1:
        raw = (data * 127 + 128).astype(np.uint8)
    else:                                   # 24-bit: three bytes a sample
        raw = np.zeros(data.size * 3, np.uint8)
    with wave_mod.open(str(path), "wb") as f:
        f.setnchannels(channels)
        f.setsampwidth(width)
        f.setframerate(sr)
        f.writeframes(raw.tobytes())


# -- copied host code, held to the originals ----------------------------------

@pytest.mark.parametrize("name", [
    "03-01-05-01-02-01-12.wav", "1001_DFA_ANG_XX.wav", "1001_DFA_ANG_XX.mp3",
    "a.b-c.flac", "plain", "-.wav", "x-y-z.tar.ogg"])
def test_audio_output_name_matches_jax(name):
    assert port_audio.audio_output_name(name) == jax_audio.audio_output_name(name)


def test_audio_output_name_contract():
    assert port_audio.audio_output_name("03-01-05-01-02-01-12.wav") == \
        "Video_Speech_Actor_12_03-01-05-01-02-01-12_voice_mp4_features.npy"
    assert port_audio.audio_output_name("1001_DFA_ANG_XX.wav") == \
        "1001_DFA_ANG_XX_voice_mp4_features.npy"


@pytest.mark.parametrize("path,folder", [
    ("/d/in/a_faces.mp4", "/d/in"), ("/d/in/Actor_01/01-02.03.mp4", "/d/in"),
    ("/d/in/x/y/z.avi", "/d/in/x"), ("rel/v.mkv", "rel")])
def test_feature_output_name_matches_jax(path, folder):
    assert port_video.feature_output_name(path, folder) == \
        jax_video.feature_output_name(path, folder)


@pytest.mark.parametrize("width,channels,sr", [
    (2, 1, 16000), (1, 1, 8000), (4, 1, 22050), (2, 2, 44100), (4, 2, 48000),
    (3, 1, 16000)])
def test_read_wav_matches_jax(tmp_path, width, channels, sr):
    """Sample widths 1, 2 and 4 and stereo decode to the same float32 mono
    waveform; 24-bit is refused (None) by both."""
    rng = np.random.default_rng(width * 10 + channels)
    shape = (700, channels) if channels > 1 else (700,)
    path = tmp_path / "a.wav"
    _write_wav(path, rng.uniform(-0.9, 0.9, size=shape), sr, width, channels)
    want, got = jax_audio._read_wav(str(path)), port_audio._read_wav(str(path))
    if width == 3:
        assert want is None and got is None
        return
    assert got[1] == want[1] == sr
    assert got[0].dtype == np.float32 and got[0].shape == (700,)
    np.testing.assert_array_equal(got[0], want[0])


def test_read_wav_rejects_what_is_no_wav(tmp_path):
    path = tmp_path / "junk.wav"
    path.write_bytes(b"not a RIFF file at all")
    assert port_audio._read_wav(str(path)) is None
    assert jax_audio._read_wav(str(path)) is None
    assert port_audio._read_wav(str(tmp_path / "missing.wav")) is None


@pytest.mark.parametrize("src,dst", [(16000, 16000), (44100, 16000),
                                     (48000, 16000), (8000, 16000)])
def test_resample_matches_jax(src, dst):
    rng = np.random.default_rng(src)
    wave = rng.normal(size=(src // 4,)).astype(np.float32)
    want, got = jax_audio.resample(wave, src, dst), port_audio.resample(wave, src, dst)
    assert got.dtype == want.dtype and got.shape == want.shape
    np.testing.assert_array_equal(got, want)
    if src == dst:
        assert got is wave


def test_load_waveform_and_file_walk_match_jax(tmp_path):
    """A 44.1 kHz stereo WAV goes through ``resample``; a non-WAV file needs
    ``ffmpeg`` and is None without a decoder for it, on both sides; the walk
    finds the same files in the same order."""
    rng = np.random.default_rng(0)
    (tmp_path / "sub").mkdir()
    _write_wav(tmp_path / "sub" / "s.wav", rng.uniform(-0.5, 0.5, (4410, 2)),
               44100, 2, 2)
    _write_wav(tmp_path / "m.WAV", rng.uniform(-0.5, 0.5, 1600))
    (tmp_path / "noise.mp3").write_bytes(b"\x00" * 64)
    (tmp_path / "notes.txt").write_text("not audio")
    got_files = list(port_audio.iter_audio_files(str(tmp_path)))
    assert got_files == list(jax_audio.iter_audio_files(str(tmp_path)))
    assert sorted(os.path.basename(p) for p in got_files) == \
        ["m.WAV", "noise.mp3", "s.wav"]
    for path in got_files:
        want, got = jax_audio.load_waveform(path), port_audio.load_waveform(path)
        if path.endswith(".mp3"):
            assert want is None and got is None
        else:
            np.testing.assert_array_equal(got, want)
    stereo = port_audio.load_waveform(str(tmp_path / "sub" / "s.wav"))
    assert abs(len(stereo) - 1600) <= 1
    assert port_audio.AUDIO_EXTENSIONS == jax_audio.AUDIO_EXTENSIONS
    assert port_audio.ffmpeg_available() == jax_audio.ffmpeg_available()


@pytest.mark.parametrize("t,chunk,dtype", [(9, 8, "uint8"), (8, 8, "uint8"),
                                           (1, 4, "float32"), (13, 4, "float32")])
def test_frames_to_chunks_matches_jax(t, chunk, dtype):
    rng = np.random.default_rng(t)
    frames = rng.integers(0, 256, size=(t, 6, 5, 3), dtype=np.uint8)
    want = jax_video.frames_to_chunks(frames, chunk, dtype)
    got = port_video.frames_to_chunks(frames, chunk, dtype)
    assert got.dtype == want.dtype and got.shape == (-(-t // chunk), chunk, 6, 5, 3)
    np.testing.assert_array_equal(got, want)
    # The last chunk is padded by repeating the final frame.
    np.testing.assert_array_equal(got[-1, -1], got[-1, (t - 1) % chunk])


def test_video_file_walk_matches_jax(tmp_path):
    (tmp_path / "a").mkdir()
    for name in ("a/z.mp4", "a/b.MKV", "c.avi", "d.txt", "e.wav"):
        (tmp_path / name).write_bytes(b"")
    assert list(port_video.iter_video_files(str(tmp_path))) == \
        list(jax_video.iter_video_files(str(tmp_path)))
    assert port_video.VIDEO_EXTENSIONS == jax_video.VIDEO_EXTENSIONS


@pytest.mark.parametrize("kind,shape,ok", [
    ("video", (3, 768), True), ("video", (3, 767), False), ("video", (768,), False),
    ("audio", (1024,), True), ("audio", (1, 1024), False), ("audio", (1023,), False)])
def test_artifact_save_and_load_match_jax(tmp_path, kind, shape, ok):
    """Round trips give the same bytes on disk and the same arrays back; what
    the contract refuses raises ``ArtifactError`` (a ``ValueError``) in both."""
    rng = np.random.default_rng(len(shape))
    arr = rng.normal(size=shape).astype(np.float32)
    save_p = getattr(port_artifacts, f"save_{kind}_features")
    save_j = getattr(jax_artifacts, f"save_{kind}_features")
    pp, pj = str(tmp_path / "p" / "x.npy"), str(tmp_path / "j" / "x.npy")
    if not ok:
        with pytest.raises(port_artifacts.ArtifactError):
            save_p(pp, arr)
        with pytest.raises(jax_artifacts.ArtifactError):
            save_j(pj, arr)
        assert issubclass(port_artifacts.ArtifactError, ValueError)
        return
    save_p(pp, arr)
    save_j(pj, arr)
    with open(pp, "rb") as f, open(pj, "rb") as g:
        assert f.read() == g.read()
    assert np.load(pp).dtype == (np.float32 if kind == "video" else np.float16)
    load_p = getattr(port_artifacts, f"load_{kind}_features")
    load_j = getattr(jax_artifacts, f"load_{kind}_features")
    np.testing.assert_array_equal(load_p(pp), load_j(pj))
    assert load_p(pp).dtype == np.float32


def test_artifact_loaders_and_validate_pair_match_jax(tmp_path):
    bad_v, bad_a, row_a = (str(tmp_path / n) for n in ("v.npy", "a.npy", "r.npy"))
    np.save(bad_v, np.zeros((2, 5), np.float32))
    np.save(bad_a, np.zeros((7,), np.float16))
    np.save(row_a, np.ones((1, 1024), np.float16))        # a (1, 1024) row loads
    for mod in (port_artifacts, jax_artifacts):
        with pytest.raises(mod.ArtifactError):
            mod.load_video_features(bad_v)
        with pytest.raises(mod.ArtifactError):
            mod.load_audio_features(bad_a)
        assert mod.load_audio_features(row_a).shape == (1024,)
        assert mod.validate_pair(np.zeros((4, 768)), np.zeros(1024)) == (4, 1024)
        with pytest.raises(mod.ArtifactError):
            mod.validate_pair(np.zeros((4, 700)), np.zeros(1024))
        with pytest.raises(mod.ArtifactError):
            mod.validate_pair(np.zeros((4, 768)), np.zeros((1, 1024)))
    assert (port_artifacts.VIDEO_DIM, port_artifacts.AUDIO_DIM) == \
        (jax_artifacts.VIDEO_DIM, jax_artifacts.AUDIO_DIM)


# -- the slice: folders in, .npy out -------------------------------------------

@pytest.fixture(scope="module")
def audio_dir(tmp_path_factory):
    """RAVDESS- and CREMA-D-style names, lengths from 15 samples (under the
    tiny conv stack's 20-sample receptive field: no output frame → zero
    embedding) to 0.9 s (split at the tiny config's 0.5 s), a 44.1 kHz
    stereo file, and an undecodable .mp3."""
    root = tmp_path_factory.mktemp("audio")
    rng = np.random.default_rng(0)
    for i, seconds in enumerate((0.2, 0.31, 0.45, 0.9, 0.26, 0.4)):
        _write_wav(root / f"03-01-0{i + 1}-01-02-01-1{i}.wav",
                   rng.uniform(-0.5, 0.5, int(seconds * SR)))
    _write_wav(root / "1001_DFA_ANG_XX.wav", rng.uniform(-0.5, 0.5, 15))
    _write_wav(root / "1002_IEO_HAP_HI.wav", rng.uniform(-0.5, 0.5, (13230, 2)),
               44100, 2, 2)
    (root / "1003_broken.mp3").write_bytes(b"\x00" * 32)
    return str(root)


@pytest.fixture(scope="module")
def audio_embedders():
    jax_emb = JaxAudioEmbedder(jax_config.Wav2Vec2Config(**TINY_A),
                               use_pallas=False)
    port_emb = AudioEmbedder(port_config.Wav2Vec2Config(**TINY_A), device=CPU,
                             params=wav2vec2_from_flax(_np_tree(jax_emb.params)))
    return jax_emb, port_emb


def test_iter_audio_embeddings_matches_jax(audio_dir, audio_embedders, capsys):
    """Same files in the same order, batches of 3 (so 8 files make three
    device batches), values to float32 summation order; the .mp3 is reported
    and skipped by both; the 15-sample clip embeds to zero."""
    jax_emb, port_emb = audio_embedders
    want = list(jax_extract.iter_audio_embeddings(audio_dir, jax_emb, 3))
    out_jax = capsys.readouterr().out
    got = list(port_extract.iter_audio_embeddings(audio_dir, port_emb, 3))
    out_port = capsys.readouterr().out
    assert out_port == out_jax and "Failed to load audio" in out_port
    assert [p for p, _ in got] == [p for p, _ in want] and len(got) == 8
    for (path, g), (_, w) in zip(got, want):
        assert g.shape == (1024,) and g.dtype == np.float32
        np.testing.assert_allclose(g, w, atol=2e-5, rtol=1e-4, err_msg=path)
        norm = 0.0 if "1001_DFA" in path else 1.0
        assert abs(float(np.linalg.norm(g)) - norm) < 1e-5


def test_extract_audio_folder_matches_jax(audio_dir, audio_embedders, tmp_path):
    """Folder to folder: the same artifact names, float16 (1024,), and values
    within one float16 step of a unit vector's entries (2^-11 below 0.125)
    on top of the float32 tolerance."""
    _, port_emb = audio_embedders
    out_j, out_p = str(tmp_path / "jax"), str(tmp_path / "port")
    n_j = jax_extract.extract_audio_folder(
        audio_dir, out_j, jax_config.Wav2Vec2Config(**TINY_A), batch_size=4,
        verbose=False)
    n_p = port_extract.extract_audio_folder(
        audio_dir, out_p, batch_size=4, verbose=False, embedder=port_emb)
    assert n_p == n_j == 8
    assert sorted(os.listdir(out_p)) == sorted(os.listdir(out_j))
    assert "Video_Speech_Actor_10_03-01-01-01-02-01-10_voice_mp4_features.npy" \
        in os.listdir(out_p)
    for name in os.listdir(out_p):
        g, w = np.load(os.path.join(out_p, name)), np.load(os.path.join(out_j, name))
        assert g.dtype == w.dtype == np.float16 and g.shape == w.shape == (1024,)
        np.testing.assert_allclose(g.astype(np.float32), w.astype(np.float32),
                                   atol=2e-5 + 2 ** -11 * 0.125, err_msg=name)


def _tiny_video_extractors(device_batch=2):
    vext = jax_extract.VideoFeatureExtractor(jax_config.ViViTConfig(**TINY_V),
                                             device_batch=device_batch,
                                             use_flash=False)
    port = port_extract.VideoFeatureExtractor(
        port_config.ViViTConfig(**TINY_V), device=CPU, device_batch=device_batch,
        params=vivit_from_flax(_np_tree(vext.params)))
    return vext, port


def test_extract_video_folder_matches_jax(tmp_path):
    """A folder of cv2-written clips (9, 4 and 17 frames → 2, 1 and 3 chunks
    of 8): the same artifact names, float32 (T, 768), values to float32
    summation order."""
    cv2 = pytest.importorskip("cv2")
    root = tmp_path / "videos"
    (root / "Actor_01").mkdir(parents=True)
    rng = np.random.default_rng(0)
    for name, n_frames in (("a_faces.mp4", 9), ("Actor_01/b.faces.mp4", 4),
                           ("c_faces.mp4", 17)):
        w = cv2.VideoWriter(str(root / name), cv2.VideoWriter_fourcc(*"mp4v"),
                            30.0, (32, 32))
        if not w.isOpened():
            pytest.skip("no mp4 encoder available")
        for _ in range(n_frames):
            w.write((rng.random((32, 32, 3)) * 255).astype(np.uint8))
        w.release()
    (root / "broken.mp4").write_bytes(b"not a video")
    vext, port = _tiny_video_extractors()
    out_j, out_p = str(tmp_path / "jax"), str(tmp_path / "port")
    n_j = jax_extract.extract_video_folder(str(root), out_j, vext, chunk_size=8,
                                           verbose=False)
    n_p = port_extract.extract_video_folder(str(root), out_p, port, chunk_size=8,
                                            verbose=False)
    assert n_p == n_j == 3
    assert sorted(os.listdir(out_p)) == sorted(os.listdir(out_j)) == [
        "Actor_01_b_faces_mp4_features.npy", "a_faces_mp4_features.npy",
        "c_faces_mp4_features.npy"]
    for name, t in (("a_faces_mp4_features.npy", 2),
                    ("Actor_01_b_faces_mp4_features.npy", 1),
                    ("c_faces_mp4_features.npy", 3)):
        g, w = np.load(os.path.join(out_p, name)), np.load(os.path.join(out_j, name))
        assert g.dtype == np.float32 and g.shape == w.shape == (t, 768)
        np.testing.assert_allclose(g, w, atol=1e-4, rtol=1e-4, err_msg=name)
    np.testing.assert_array_equal(
        port_video.load_video_chunks(str(root / "a_faces.mp4"), 8, (32, 32), "uint8"),
        jax_video.load_video_chunks(str(root / "a_faces.mp4"), 8, (32, 32), "uint8"))
    assert port_video.video_fps(str(root / "a_faces.mp4")) == \
        jax_video.video_fps(str(root / "a_faces.mp4"))


def test_iter_video_features_batches_across_videos(monkeypatch, capsys):
    """Decoded chunks of several videos share ``embed_chunks`` calls (a flush
    once ``max(4 * device_batch, 32)`` chunks wait, then the rest); each
    video gets its own rows back, in walk order; an undecodable file is
    reported and skipped.  Decoding is replaced by seeded arrays."""
    _, port = _tiny_video_extractors()
    counts = {"/v/a.mp4": 20, "/v/b.mp4": 13, "/v/bad.mp4": None, "/v/c.mp4": 3}

    def fake_chunks(path, chunk_size, size, dtype):
        n = counts[path]
        assert (chunk_size, size, dtype) == (8, (32, 32), "uint8")
        if n is None:
            return None
        return np.random.default_rng(n).integers(
            0, 256, size=(n, 8, 32, 32, 3), dtype=np.uint8)

    monkeypatch.setattr(port_extract, "iter_video_files", lambda d: iter(counts))
    monkeypatch.setattr(port_extract, "load_video_chunks", fake_chunks)
    calls = []
    embed = port.embed_chunks
    monkeypatch.setattr(port, "embed_chunks",
                        lambda x: calls.append(len(x)) or embed(x))
    got = list(port_extract.iter_video_features("/v", port, decode_workers=2))
    assert calls == [33, 3]
    assert [p for p, _ in got] == ["/v/a.mp4", "/v/b.mp4", "/v/c.mp4"]
    assert "Failed to load video: /v/bad.mp4" in capsys.readouterr().out
    for path, feats in got:
        assert feats.shape == (counts[path], 768)
        np.testing.assert_allclose(feats, embed(fake_chunks(path, 8, (32, 32), "uint8")),
                                   atol=1e-5)


def test_embed_chunks_pipeline_equals_serial():
    """Double-buffered blocks give bit-identical rows, for chunk counts that
    fill one, two and three device batches (the last one padded)."""
    _, port = _tiny_video_extractors()
    rng = np.random.default_rng(3)
    for n in (1, 4, 5):
        chunks = rng.integers(0, 256, size=(n, 8, 32, 32, 3), dtype=np.uint8)
        serial = port.embed_chunks(chunks)
        piped = port.embed_chunks(chunks, pipeline=True)
        assert piped.shape == (n, 768)
        np.testing.assert_array_equal(piped, serial)


def test_main_writes_artifacts_on_the_cpu(audio_dir, tmp_path, monkeypatch):
    """The CLI at tiny default configs (the full-width ones are the card's
    work): ``audio`` and ``video`` sub-commands with ``--device cpu`` write
    the artifacts, and ``--params`` persists the ViViT weights."""
    monkeypatch.setattr(port_extract, "Wav2Vec2Config",
                        functools.partial(port_config.Wav2Vec2Config, **TINY_A))
    monkeypatch.setattr(port_extract, "ViViTConfig",
                        functools.partial(port_config.ViViTConfig, **TINY_V))
    out_a = tmp_path / "a"
    port_extract.main(["audio", "--input", audio_dir, "--output", str(out_a),
                       "--batch_size", "64", "--device", "cpu"])
    assert len(os.listdir(out_a)) == 8
    emb = np.load(out_a / "1002_IEO_HAP_HI_voice_mp4_features.npy")
    assert emb.dtype == np.float16 and emb.shape == (1024,)
    assert abs(float(np.linalg.norm(emb.astype(np.float32))) - 1.0) < 1e-2

    monkeypatch.setattr(port_extract, "iter_video_files",
                        lambda d: iter([os.path.join(d, "clip.mp4")]))
    monkeypatch.setattr(
        port_extract, "load_video_chunks",
        lambda p, chunk_size, size, dtype: np.zeros((3, chunk_size, *size, 3), np.uint8))
    out_v, params = tmp_path / "v", tmp_path / "vivit.npz"
    port_extract.main(["video", "--input", str(tmp_path), "--output", str(out_v),
                       "--chunk_size", "8", "--device_batch", "2",
                       "--params", str(params), "--device", "cpu"])
    feats = np.load(out_v / "clip_mp4_features.npy")
    assert feats.dtype == np.float32 and feats.shape == (3, 768)
    assert np.isfinite(feats).all() and params.exists()


def test_main_fails_without_cuda_and_has_no_mesh_option(audio_dir, tmp_path):
    """The CLI runs on the GPU unless told otherwise: with no CUDA device it
    raises, it never drops to the CPU by itself, ``--mesh`` (the video
    subcommand's, since the scale-out slice) included."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="CUDA"):
        port_extract.main(["audio", "--input", audio_dir, "--output",
                           str(tmp_path / "out")])
    assert not (tmp_path / "out").exists()
    with pytest.raises(RuntimeError, match="CUDA"):
        port_extract.main(["video", "--input", audio_dir, "--output",
                           str(tmp_path / "out"), "--mesh"])
    assert not (tmp_path / "out").exists()
    with pytest.raises(SystemExit):
        port_extract.main(["audio", "--input", audio_dir, "--output",
                           str(tmp_path / "out"), "--mesh", "--device", "cpu"])
