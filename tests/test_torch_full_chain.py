"""The port's chain scripts on the CPU: ``scripts/full_chain.py``'s clip
maker, container round trip, vote and thresholds, ``scripts/e2e_demo.py``'s
dataset, and the whole ``full_chain --tiny --device cpu`` run (marked
``slow``: its host tracker alone reads ~33 ms a frame over ~4,000 frames on
a CPU host, minutes in all).
"""

import os
import sys
import types
import wave

import numpy as np
import pytest

cv2 = pytest.importorskip("cv2")

from mmer_tpu_torch.scripts import e2e_demo, full_chain

from torch_threads import few_threads  # noqa: F401


def test_span_vote_takes_the_engines_window_clamp():
    """Windows cover min(window, n - s) subchunks with the engine's clamp
    ``min(5, max_seq_len - 1)``: at max_seq_len 3 a window spans 2, so of
    three windows (spans 2, 2, 1) the last two outvote the first; the JAX
    script's ``min(5, max_seq_len)`` (spans 3, 2, 1) would tie them and
    return the first class."""
    assert full_chain.span_vote(["HAP", "SAD", "SAD"], 3) == "SAD"
    assert full_chain.span_vote(["HAP", "HAP", "SAD", "SAD"], 3) == "HAP"
    assert full_chain.span_vote(["ANG"], 6) == "ANG"
    assert full_chain.span_vote(["NEU", "FEA", "FEA", "FEA"], 6) == "FEA"


def test_raw_clip_frames_tilt_and_occlusion():
    face = full_chain.packaged_face()
    assert face.shape == (180, 180, 3) and face.dtype == np.uint8
    plain = full_chain.raw_clip_frames(face, np.random.default_rng(0), 12)
    assert plain.shape == (12, 360, 480, 3) and plain.dtype == np.uint8
    again = full_chain.raw_clip_frames(face, np.random.default_rng(0), 12)
    np.testing.assert_array_equal(plain, again)
    covered = full_chain.raw_clip_frames(face, np.random.default_rng(0), 12,
                                         occlusion=(0.4, 3, 6))
    tilted = full_chain.raw_clip_frames(face, np.random.default_rng(0), 12,
                                        tilt=(30.0, 3, 6))
    for other in (covered, tilted):
        changed = [t for t in range(12) if not np.array_equal(other[t], plain[t])]
        assert changed == [3, 4, 5]
    assert (covered[4] == 70).all(-1).sum() > 1000      # the grey bar
    tone = full_chain.label_tone(2, 45, np.random.default_rng(1))
    assert tone.dtype == np.float32 and tone.shape == (24000,)


def test_e2e_demo_dataset(tmp_path):
    e2e_demo.generate_dataset(str(tmp_path), actors=1, frames=(33, 34))
    keys = [full_chain.clip_key(1001, ei) for ei in range(6)]
    assert sorted(os.listdir(tmp_path / "videos")) == sorted(f"{k}_faces.mp4" for k in keys)
    assert sorted(os.listdir(tmp_path / "audio")) == sorted(f"{k}.wav" for k in keys)
    cap = cv2.VideoCapture(str(tmp_path / "videos" / f"{keys[0]}_faces.mp4"))
    n = 0
    while cap.read()[0]:
        n += 1
    cap.release()
    assert n == 33
    with wave.open(str(tmp_path / "audio" / f"{keys[0]}.wav")) as f:
        assert (f.getframerate(), f.getnframes()) == (16000, 16000)


def test_make_clips_draws_clip_by_clip():
    """make_clips draws each clip's length, frames and tone in that order
    from one generator, actor by actor, emotion by emotion, with the
    emotion's extras."""
    extras = {1: {"tilt": (30.0, 2, 5)}}
    clips = list(full_chain.make_clips(1, np.random.default_rng(3), (33, 36),
                                       first_actor=1011, extras=extras))
    rng = np.random.default_rng(3)
    face = full_chain.packaged_face()
    assert [c.key for c in clips] == [full_chain.clip_key(1011, ei)
                                      for ei in range(6)]
    for ei, clip in enumerate(clips):
        n = int(rng.integers(33, 36))
        frames = full_chain.raw_clip_frames(face, rng, n, **extras.get(ei, {}))
        np.testing.assert_array_equal(clip.frames, frames)
        np.testing.assert_array_equal(clip.wave, full_chain.label_tone(ei, n, rng))
        assert clip.emotion == ei and clip.path is None


def test_raw_clip_container_round_trip(tmp_path):
    """write_raw_clip → decode_raw_clip: every frame back at the clip's
    size, in RGB order, the tone back from its PCM track to within one
    16-bit step.  mp4v is lossy on the noise background (10.5 grey levels a
    pixel on average here), so the frames are compared as 8x8 block means,
    which it keeps (2.1 on average, 8.5 at most); a BGR frame or frames out
    of order move the face's blocks by tens of levels."""
    clip = next(full_chain.make_clips(1, np.random.default_rng(4), (33, 34)))
    path = full_chain.write_raw_clip(clip, str(tmp_path))
    back = full_chain.decode_raw_clip(path, clip.key, clip.emotion)
    assert (back.key, back.emotion, back.path) == (clip.key, clip.emotion, path)
    assert back.frames.shape == clip.frames.shape
    def blocks(x):
        n, h, w, c = x.shape
        return x.astype(float).reshape(n, h // 8, 8, w // 8, 8, c).mean((2, 4))

    err = np.abs(blocks(back.frames) - blocks(clip.frames))
    assert err.mean() < 3 and err.max() < 12
    assert back.wave.shape == clip.wave.shape
    np.testing.assert_allclose(back.wave, clip.wave, atol=1 / 32768 + 1e-7)


def test_chain_result_thresholds():
    """ChainResult.ok is the JAX script's check: best test accuracy above
    80 % and at least 5 of 6 probes recovered."""
    def result(accs, votes):
        return full_chain.ChainResult(
            track=None, track_s=0.0, crop_s=0.0, crop_worst=None, clips=60,
            embed_s=0.0, results=[{"test_acc": a} for a in accs], train_s=0.0,
            votes=votes)
    hit = [(e, [e], e) for e in full_chain.EMOTIONS]
    one_miss = hit[:5] + [("DIS", ["NEU"], "NEU")]
    assert result([50.0, 90.0], hit).ok
    assert result([50.0, 90.0], one_miss).ok
    assert result([50.0, 90.0], one_miss).hits == 5
    assert not result([50.0, 80.0], hit).ok
    assert not result([90.0], one_miss[:4] + [("FEA", [], None)] * 2).ok


@pytest.mark.slow
def test_full_chain_tiny_on_the_cpu(tmp_path):
    """Raw mp4s written and decoded → the chain (tracker, crops, tiny
    extractors, training) → HTTP uploads of held-out clips, with the
    script's own thresholds (accuracy > 80 %, recovery >= 5/6)."""
    assert full_chain.main(["--tiny", "--device", "cpu", "--actors", "10",
                            "--root", str(tmp_path / "chain")]) == 0


# -- the trainer's flags, against the JAX scripts' ------------------------------------

class _TrainRecorder:
    """A stand-in for ``train.cli.main``: records each argument list and
    returns a run good enough for the scripts' own checks."""

    def __init__(self):
        self.calls = []

    def __call__(self, argv):
        self.calls.append(list(argv))
        return types.SimpleNamespace(hyperparameters={"max_seq_len": 4},
                                     results=[{"test_acc": 90.0}])


def _flags(argv):
    """An argument list as {flag: value}, paths cut to their last part and
    the port's ``--device`` dropped."""
    out, i = {}, 0
    while i < len(argv):
        if i + 1 < len(argv) and not argv[i + 1].startswith("--"):
            out[argv[i]] = os.path.basename(argv[i + 1])
            i += 2
        else:
            out[argv[i]] = True
            i += 1
    out.pop("--device", None)
    return out


@pytest.mark.parametrize("hbm", [False, True])
def test_e2e_demo_trains_fused_as_the_jax_script(monkeypatch, tmp_path, hbm):
    """Both routes of ``e2e_demo.main`` pass ``--fused`` (JAX's fused key
    schedule: a run from seed s then draws what the JAX run draws) and the
    JAX script's other flags, recorded through stubs of the trainer, the
    extractors and the clip writer."""
    import mmer_tpu.core.cache as jax_cache
    import mmer_tpu.preprocess.extract as jax_extract
    import mmer_tpu.train.cli as jax_cli
    import scripts.e2e_demo as jax_e2e
    from mmer_tpu_torch.preprocess import extract as port_extract
    from mmer_tpu_torch.train import cli as port_cli

    jax_rec, port_rec = _TrainRecorder(), _TrainRecorder()
    for mod, rec in ((jax_cli, jax_rec), (port_cli, port_rec)):
        monkeypatch.setattr(mod, "main", rec)
    for mod in (jax_extract, port_extract):
        for name in ("extract_video_folder", "extract_audio_folder"):
            monkeypatch.setattr(mod, name, lambda *a, **k: None)
    for mod in (jax_e2e, e2e_demo):
        monkeypatch.setattr(mod, "generate_dataset", lambda root, actors: os.makedirs(root))
    monkeypatch.setattr(jax_cache, "enable_persistent_cache", lambda *a, **k: None)
    route = ["--hbm"] if hbm else []
    monkeypatch.setattr(sys, "argv", ["e2e_demo", "--root", str(tmp_path / "j")]
                        + route)
    jax_e2e.main()
    assert e2e_demo.main(["--root", str(tmp_path / "p"), "--device", "cpu"]
                         + route) == 0
    assert len(port_rec.calls) == len(jax_rec.calls) == 1
    assert "--fused" in port_rec.calls[0]
    assert _flags(port_rec.calls[0]) == _flags(jax_rec.calls[0])
    assert ("--raw_videos" in port_rec.calls[0]) == hbm


def test_run_chain_trains_fused(monkeypatch, tmp_path):
    """``full_chain.run_chain`` step 5 passes ``--fused``, as
    ``scripts/full_chain.py`` does: twelve small clips through stubbed boxes
    (the host tracker costs ~33 ms a frame) and a fixed 8/2/2 split (the
    80/10/10 one needs 60 clips), real crops and tiny extractors, up to the
    trainer's recorded call."""
    from mmer_tpu_torch.data import pipeline
    from mmer_tpu_torch.preprocess import faces
    from mmer_tpu_torch.train import cli as port_cli

    class Stop(Exception):
        pass

    calls = []

    def train_main(argv):
        calls.append(list(argv))
        raise Stop

    def boxes(frames, detector=None, stats=None):
        stats.frames += len(frames)
        stats.full += len(frames)
        return [(i, 8.0, 6.0, 40.0, 44.0, 0.9) for i in range(len(frames))]

    monkeypatch.setattr(port_cli, "main", train_main)
    monkeypatch.setattr(faces, "extract_frame_bboxes", boxes)
    monkeypatch.setattr(faces, "HaarFaceDetector", lambda: None)
    monkeypatch.setattr(pipeline, "stratified_splits", lambda labels, seed: (
        np.arange(8), np.arange(8, 10), np.arange(10, 12)))
    rng = np.random.default_rng(5)
    clips = [full_chain.Clip(full_chain.clip_key(actor, ei), ei,
                             rng.integers(0, 255, (n, 48, 64, 3), dtype=np.uint8),
                             rng.normal(size=8000).astype(np.float32))
             for actor in (1001, 1002)
             for ei, n in enumerate((40, 70, 40, 70, 40, 70))]
    vivit_cfg, wav_cfg = full_chain._tiny_configs()
    with pytest.raises(Stop):
        full_chain.run_chain(clips, [], str(tmp_path), "cpu",
                             vivit_cfg=vivit_cfg, wav_cfg=wav_cfg, epochs=3,
                             log=lambda s: None)
    assert len(calls) == 1 and "--fused" in calls[0]
    assert calls[0][calls[0].index("--num_epochs") + 1] == "3"
