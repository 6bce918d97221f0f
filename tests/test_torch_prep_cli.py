"""The port's prep CLI against the JAX package's, on the CPU.

- ``python -m mmer_tpu_torch.preprocess.prep bboxes / faces / audio`` on a
  folder of six raw clips (tilted and occluded runs included, a PCM tone
  muxed into each) against ``mmer_tpu.preprocess.prep``: the same file
  names, byte-equal WAV files, ``.txt`` files byte-equal but for a tracked
  row's score that straddles a rounding step (below), face videos of the
  same frames within the crops' bound; ``--detector yolo`` refused.

The raw-media training route is ``tests/test_torch_raw_route.py``'s.
"""

import os
import wave

import numpy as np
import pytest

cv2 = pytest.importorskip("cv2")

from mmer_tpu.preprocess.prep import main as jax_prep
from mmer_tpu_torch.preprocess.prep import main as port_prep
from mmer_tpu_torch.scripts import full_chain
from mmer_tpu_torch.serve.pcm_mp4 import mux_pcm_into_file

from test_torch_prep import assert_txt_equal
from torch_threads import few_threads  # noqa: F401


# -- prep on six raw clips ----------------------------------------------------------

@pytest.fixture(scope="module")
def prepped(tmp_path_factory):
    """Six raw 360x480 clips, then both CLIs' three subcommands."""
    root = tmp_path_factory.mktemp("prep")
    raw = root / "raw"
    raw.mkdir()
    face = full_chain.packaged_face()
    rng = np.random.default_rng(3)
    extras = [{}, {"tilt": (30.0, 6, 18)}, {"occlusion": (0.4, 6, 18)},
              {"tilt": (-30.0, 4, 12)}, {}, {"occlusion": (0.4, 10, 20)}]
    for ei, extra in enumerate(extras):
        n = int(rng.integers(20, 29))
        frames = full_chain.raw_clip_frames(face, rng, n, **extra)
        path = str(raw / f"{full_chain.clip_key(1001, ei)}.mp4")
        w = cv2.VideoWriter(path, cv2.VideoWriter_fourcc(*"mp4v"), 30.0, (480, 360))
        if not w.isOpened():
            pytest.skip("no mp4 encoder")
        for f in frames:
            w.write(np.ascontiguousarray(f[:, :, ::-1]))
        w.release()
        mux_pcm_into_file(path, full_chain.label_tone(ei, n, rng), 16000)
    out = {}
    for name, prep, extra in (("port", port_prep, ["--device", "cpu"]),
                              ("jax", jax_prep, [])):
        base = root / name
        assert prep(["bboxes", "--input", str(raw), "--output",
                     str(base / "bboxes")]) == 0
        assert prep(["faces", "--videos", str(raw), "--bboxes",
                     str(base / "bboxes"), "--output", str(base / "faces"),
                     "--size", "112"] + extra) == 0
        assert prep(["audio", "--input", str(raw), "--output",
                     str(base / "audio")]) == 0
        out[name] = base
    return out


def _files(folder):
    return sorted(os.listdir(folder))


def test_prep_bboxes_writes_jax_files(prepped):
    port, jax = prepped["port"] / "bboxes", prepped["jax"] / "bboxes"
    assert _files(port) == _files(jax) == sorted(
        f"{full_chain.clip_key(1001, ei)}_bboxes.txt" for ei in range(6))
    for name in _files(jax):
        assert_txt_equal((port / name).read_text(), (jax / name).read_text())
    assert all((jax / name).stat().st_size for name in _files(jax))


def _decode(path):
    cap = cv2.VideoCapture(str(path))
    frames = []
    while True:
        ok, frame = cap.read()
        if not ok:
            break
        frames.append(frame)
    cap.release()
    return np.stack(frames).astype(int)


def test_prep_faces_writes_jax_videos(prepped):
    """The same names, frame counts and sizes; decoded frames of the two
    writers' mp4s on average within one grey level (the crops agree to 1
    level on < 0.1 % of values, then the encoder runs on each)."""
    port, jax = prepped["port"] / "faces", prepped["jax"] / "faces"
    assert _files(port) == _files(jax) == sorted(
        f"{full_chain.clip_key(1001, ei)}_faces.mp4" for ei in range(6))
    for name in _files(jax):
        got, want = _decode(port / name), _decode(jax / name)
        assert got.shape == want.shape and got.shape[1:] == (112, 112, 3)
        assert np.abs(got - want).mean() < 1.0, name


def test_prep_audio_writes_jax_wavs(prepped):
    port, jax = prepped["port"] / "audio", prepped["jax"] / "audio"
    assert _files(port) == _files(jax) == sorted(
        f"{full_chain.clip_key(1001, ei)}.wav" for ei in range(6))
    for name in _files(jax):
        with wave.open(str(port / name)) as a, wave.open(str(jax / name)) as b:
            assert a.getparams() == b.getparams()
            assert a.readframes(a.getnframes()) == b.readframes(b.getnframes())


def test_prep_refuses_yolo(tmp_path, capsys):
    assert port_prep(["bboxes", "--input", str(tmp_path), "--output",
                      str(tmp_path / "out"), "--detector", "yolo"]) != 0
    assert "yolo is not available" in capsys.readouterr().err
