"""The port's host media code against the JAX package's, on the CPU.

The container copies (``serve/remux.py``, ``serve/pcm_mp4.py``,
``serve/transcode.py``) must give byte-equal outputs on the inputs of the
JAX package's own tests; ``extract_audio_track`` the same waveform.  The
face detector runs without ``cv2``: its grayscale conversion is held to
``cv2.cvtColor`` bit for bit, its area resampling to ``cv2.resize(INTER_AREA)``
within 1e-9 at every pyramid size of the serving frames, and its boxes, on
both engines, to the JAX detector's.
"""

import gzip
import os
import struct
import subprocess
import sys

import numpy as np
import pytest

cv2 = pytest.importorskip("cv2")

from mmer_tpu.preprocess.audio import extract_audio_track as jax_extract_audio_track
from mmer_tpu.preprocess.faces import HaarFaceDetector as JaxHaarFaceDetector
from mmer_tpu.serve import pcm_mp4 as jax_pcm
from mmer_tpu.serve import remux as jax_remux
from mmer_tpu.serve import transcode as jax_transcode
from mmer_tpu_torch.preprocess import audio as port_audio
from mmer_tpu_torch.preprocess.cascade import (HaarCascade, _resize_area,
                                               find_cascade_file,
                                               read_cascade_xml)
from mmer_tpu_torch.preprocess.faces import HaarFaceDetector, _rgb_to_gray
from mmer_tpu_torch.serve import pcm_mp4 as port_pcm
from mmer_tpu_torch.serve import remux as port_remux
from mmer_tpu_torch.serve import transcode as port_transcode

import test_remux as jax_remux_tests
from torch_threads import few_threads  # noqa: F401

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SYSTEM_CASCADE = "/usr/share/opencv4/haarcascades/haarcascade_frontalface_default.xml"


def _grace_hopper() -> np.ndarray:
    pytest.importorskip("matplotlib")
    from matplotlib import cbook
    from PIL import Image

    return np.asarray(Image.open(
        cbook.get_sample_data("grace_hopper.jpg", asfileobj=False)))


def _jittered_faces(n: int, seed: int = 0):
    """The serving tests' face frames: grace_hopper at 300x256 with seeded
    ±8 jitter, alone and pasted on a smooth 480x640 background."""
    img = cv2.resize(_grace_hopper(), (256, 300))
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:480, 0:640]
    background = np.stack([60 + yy * 0.2, 80 + xx * 0.1,
                           100 + 0 * xx], -1).astype(np.uint8)
    out = []
    for _ in range(n):
        face = np.clip(img.astype(np.int16) + rng.integers(-8, 8, img.shape),
                       0, 255).astype(np.uint8)
        big = background.copy()
        big[90:390, 192:448] = face
        out += [face, big]
    return out


def _face_mp4(path: str, frames: int = 4) -> None:
    img = cv2.resize(_grace_hopper(), (256, 300))
    w = cv2.VideoWriter(path, cv2.VideoWriter_fourcc(*"mp4v"), 30.0,
                        (256, 300))
    if not w.isOpened():
        pytest.skip("no mp4 encoder")
    rng = np.random.default_rng(0)
    for _ in range(frames):
        jitter = img.astype(np.int16) + rng.integers(-8, 8, img.shape)
        w.write(np.clip(jitter, 0, 255).astype(np.uint8)[:, :, ::-1])
    w.release()


# -- containers ----------------------------------------------------------------

FLV_INPUTS = {
    "av": lambda: jax_remux_tests.make_flv(),
    "video_only": lambda: jax_remux_tests.make_flv(with_audio=False),
    "audio_only": lambda: jax_remux_tests.make_flv(with_video=False),
    "cts": lambda: jax_remux_tests.make_flv(video_cts=(0, 40, 0, 0)),
    "mp3": lambda: jax_remux_tests.make_mp3_flv(),
    "mp3_audio_only": lambda: jax_remux_tests.make_mp3_flv(with_video=False),
}


@pytest.mark.parametrize("name", sorted(FLV_INPUTS))
def test_remux_copy_is_byte_equal(name):
    flv = FLV_INPUTS[name]()
    want = jax_remux.flv_to_mp4(flv)
    assert port_remux.flv_to_mp4(flv) == want
    assert port_transcode.flv_preview_mp4(flv) == \
        jax_transcode.flv_preview_mp4(flv)


def test_remux_refusals_match():
    bad_codec = bytearray(jax_remux_tests.make_flv(with_audio=False))
    for payload in (b"not an flv", bytes(bad_codec[:40])):
        with pytest.raises(jax_remux.RemuxError) as want:
            jax_remux.flv_to_mp4(payload)
        with pytest.raises(port_remux.RemuxError) as got:
            port_remux.flv_to_mp4(payload)
        assert str(got.value) == str(want.value)
    assert port_remux.parse_sps(jax_remux_tests.make_sps()) == \
        jax_remux.parse_sps(jax_remux_tests.make_sps())


def test_transcode_fallback_is_byte_equal():
    """An FLV1 (Sorenson) upload takes the cv2 mp4v route in both copies,
    with an MP3 track byte-copied next to it."""
    flv = bytearray(jax_remux_tests._cv2_flv1_bytes(6))
    flv[4] = 0x05
    for i in range(3):
        flv += jax_remux_tests.mp3_audio_tag(i * 26)
    want = jax_transcode.flv_preview_mp4(bytes(flv))
    got = port_transcode.flv_preview_mp4(bytes(flv))
    assert got[1] == want[1] == "transcode"
    assert got[0] == want[0]


def test_pcm_mux_and_demux_match(tmp_path):
    src = str(tmp_path / "v.mp4")
    _face_mp4(src)
    mp4 = open(src, "rb").read()
    wave = (np.random.default_rng(3).normal(size=12345) * 0.2).astype(np.float32)
    muxed = jax_pcm.mux_pcm_track(mp4, wave, 16000)
    assert port_pcm.mux_pcm_track(mp4, wave, 16000) == muxed
    want_wave, want_rate = jax_pcm.demux_pcm_track(muxed)
    got_wave, got_rate = port_pcm.demux_pcm_track(muxed)
    assert got_rate == want_rate == 16000
    np.testing.assert_array_equal(got_wave, want_wave)
    path = tmp_path / "in_file.mp4"
    path.write_bytes(mp4)
    port_pcm.mux_pcm_into_file(str(path), wave, 16000)
    assert path.read_bytes() == muxed
    for bad in (b"not an mp4", muxed[:-40]):
        assert jax_pcm.demux_pcm_track(bad) is None
        assert port_pcm.demux_pcm_track(bad) is None
    with pytest.raises(port_pcm.MuxError):
        port_pcm.mux_pcm_track(mp4, np.zeros(0, np.float32), 16000)


def _crafted_sample_table(muxed: bytes, n_samples: int) -> bytes:
    """``muxed`` with its PCM track's stsz/stsc claiming ``n_samples``
    2-byte samples in its one chunk (the file holds far fewer)."""
    out = bytearray(muxed)
    at = out.rfind(b"stsz")
    struct.pack_into(">I", out, at + 12, n_samples)         # stsz count
    at = out.rfind(b"stsc")
    struct.pack_into(">I", out, at + 16, n_samples)         # samples/chunk
    return bytes(out)


def test_pcm_demux_refuses_a_table_past_the_file(tmp_path):
    """The port's one deliberate difference: a sample table that claims
    more bytes than the file holds is refused before the read, however
    large the claim; the JAX original reads what is there."""
    src = str(tmp_path / "v.mp4")
    _face_mp4(src)
    wave = np.full(800, 0.25, np.float32)
    muxed = jax_pcm.mux_pcm_track(open(src, "rb").read(), wave, 16000)
    crafted = _crafted_sample_table(muxed, 2 ** 31 - 1)     # ~4 GiB claimed
    assert port_pcm.demux_pcm_track(crafted) is None
    path = tmp_path / "crafted.mp4"
    path.write_bytes(crafted)
    assert port_pcm.demux_pcm_track(str(path)) is None
    assert port_audio.extract_audio_track(str(path)) is None
    # The chunk starts where the stco table says; a claim that ends one
    # sample past the file is refused, one that ends at its last byte read.
    at = muxed.rfind(b"stco")
    (offset,) = struct.unpack(">I", muxed[at + 12:at + 16])
    fits = (len(muxed) - offset) // 2
    assert port_pcm.demux_pcm_track(
        _crafted_sample_table(muxed, fits + 1)) is None
    got = port_pcm.demux_pcm_track(_crafted_sample_table(muxed, fits))
    want = jax_pcm.demux_pcm_track(_crafted_sample_table(muxed, fits))
    np.testing.assert_array_equal(got[0], want[0])
    np.testing.assert_array_equal(got[0][:800],
                                  jax_pcm.demux_pcm_track(muxed)[0])


@pytest.mark.parametrize("window", [(None, None), (0.25, 0.5), (5.0, None)])
def test_extract_audio_track_matches_jax(tmp_path, window):
    src = str(tmp_path / "v.mp4")
    _face_mp4(src)
    t = np.arange(16000) / 16000
    wave = (0.5 * np.sin(2 * np.pi * 330 * t)).astype(np.float32)
    jax_pcm.mux_pcm_into_file(src, wave, 16000)
    start, duration = window
    for rate in (16000, 8000):
        want = jax_extract_audio_track(src, rate, start, duration)
        got = port_audio.extract_audio_track(src, rate, start, duration)
        if want is None:
            assert got is None
        else:
            np.testing.assert_array_equal(got, want)
    wav_path = str(tmp_path / "out.wav")
    assert port_audio.extract_audio_to_wav(src, wav_path)
    np.testing.assert_allclose(port_audio.load_waveform(wav_path), wave,
                               atol=1.0 / 32768)
    assert not port_audio.extract_audio_to_wav(str(tmp_path / "none.mp4"),
                                               wav_path)


# -- face detection without cv2 ---------------------------------------------------

def test_packaged_cascade_equals_the_system_file():
    path = find_cascade_file()
    assert path is not None and path.endswith(".gz")
    xml = read_cascade_xml(path)
    assert b"Intel License Agreement" in xml
    if os.path.exists(SYSTEM_CASCADE):
        with open(SYSTEM_CASCADE, "rb") as f:
            assert xml == f.read()
        with gzip.open(path, "rb") as f:
            assert f.read() == xml


def test_packaged_face_frame_is_grace_hopper_at_300x256():
    """The frame ``chip_smoke.py`` serves (the card has no image decoder):
    matplotlib's grace_hopper.jpg through ``cv2.resize(img, (256, 300))``,
    as ``tests/test_serve.py`` makes its frame."""
    path = os.path.join(REPO, "mmer_tpu_torch", "assets", "face_300x256.npy")
    face = np.load(path, allow_pickle=False)
    assert face.dtype == np.uint8 and face.shape == (300, 256, 3)
    np.testing.assert_array_equal(face, cv2.resize(_grace_hopper(), (256, 300)))
    assert HaarFaceDetector().detect(face)


def test_rgb_to_gray_is_bit_equal_to_cv2():
    v = np.arange(256, dtype=np.uint8)
    r, g, b = np.meshgrid(v, v, v, indexing="ij")
    every = np.stack([r, g, b], -1).reshape(4096, 4096, 3)   # all 2^24 colours
    np.testing.assert_array_equal(_rgb_to_gray(every),
                                  cv2.cvtColor(every, cv2.COLOR_RGB2GRAY))
    face = _jittered_faces(1)[1]
    np.testing.assert_array_equal(_rgb_to_gray(face),
                                  cv2.cvtColor(face, cv2.COLOR_RGB2GRAY))


@pytest.mark.parametrize("hw", [(480, 640), (300, 256), (600, 512)])
def test_resize_area_matches_cv2_at_every_pyramid_size(hw):
    h, w = hw
    cascade = HaarCascade(find_cascade_file())
    rng = np.random.default_rng(h)
    img = rng.random((h, w)) * 255
    gray = _rgb_to_gray(_jittered_faces(1)[1]).astype(np.float64)
    sizes = {(sw, sh) for factor in (1.1, 1.2)
             for _, sw, sh in cascade._pyramid(h, w, factor, 48)}
    assert len(sizes) > 10
    for sw, sh in sorted(sizes):
        for src in (img, cv2.resize(gray, (w, h))):
            want = cv2.resize(src, (sw, sh), interpolation=cv2.INTER_AREA)
            got = _resize_area(src, (sw, sh))
            assert got.shape == want.shape
            np.testing.assert_allclose(got, want, rtol=0, atol=1e-9)


def _test_pattern_frames():
    """tests/test_faces.py's frames: the portrait, a ±15-jittered copy,
    uniform noise at its size and at 120x160 (no face)."""
    img = _grace_hopper()
    rng = np.random.default_rng(0)
    return [img,
            np.clip(img.astype(np.int16) + rng.integers(-15, 15, img.shape),
                    0, 255).astype(np.uint8),
            (rng.random(img.shape) * 255).astype(np.uint8),
            (np.random.default_rng(0).random((120, 160, 3)) * 255
             ).astype(np.uint8)]


def _same_boxes(got, want, where):
    """Equal boxes and confidences.  A window on a border can flip between
    engines (float summation order); such a box is named, and may move at
    most 1 px a corner."""
    assert len(got) == len(want), (where, got, want)
    for g, w in zip(got, want):
        if g != w:
            corners = np.abs(np.asarray(g[:4]) - np.asarray(w[:4]))
            assert g[4] == w[4] and corners.max() <= 1.0, (where, g, w)
            print(f"{where}: border window flipped, {g} vs {w}")


def _force_numpy_engine(monkeypatch):
    """The native evaluator's build fails: the cascade falls back to numpy."""
    from mmer_tpu_torch.ops import _build
    from mmer_tpu_torch.preprocess import cascade

    def no_compiler(name):
        raise RuntimeError("no C++ compiler")

    monkeypatch.setattr(_build, "host_library", no_compiler)
    monkeypatch.setattr(cascade, "_NATIVE_CTX_CACHE", {})


@pytest.mark.parametrize("engine", ["native", "numpy"])
def test_detector_matches_jax(engine, monkeypatch):
    if engine == "numpy":
        _force_numpy_engine(monkeypatch)
    port = HaarFaceDetector()
    assert port.engine == engine
    jax_det = JaxHaarFaceDetector()
    frames = _jittered_faces(2) + _test_pattern_frames()
    found = 0
    for i, frame in enumerate(frames):
        want = jax_det.detect(frame)
        got = port.detect(frame)
        _same_boxes(got, want, f"frame {i} {frame.shape}")
        found += bool(got)
    assert found == len(frames) - 2          # both noise frames: no face


def test_numpy_engine_is_the_fallback(monkeypatch):
    """When the native evaluator does not build, the cascade runs numpy,
    says so, and finds the same boxes."""
    gray = _rgb_to_gray(_jittered_faces(1)[0])
    native = HaarCascade(find_cascade_file())
    assert native.engine == "native"
    want = native.detect(gray, scale_factor=1.1)
    _force_numpy_engine(monkeypatch)
    fallback = HaarCascade(find_cascade_file())
    assert fallback.engine == "numpy"
    assert fallback.detect(gray, scale_factor=1.1) == want
    assert fallback.detect_many([gray, gray], scale_factor=1.1) == [want, want]


def test_native_library_builds_into_the_build_dir(tmp_path):
    """csrc/cascade_eval.cpp is built with g++ into the build directory,
    under a name keyed by its source, in a fresh process."""
    code = ("from mmer_tpu_torch.ops import _build\n"
            "lib = _build.host_library('cascade_eval')\n"
            "print(lib._name)\n")
    env = dict(os.environ, MMER_TORCH_BUILD_DIR=str(tmp_path))
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr
    built = proc.stdout.strip()
    assert built.startswith(str(tmp_path)) and "cascade_eval-host-" in built
