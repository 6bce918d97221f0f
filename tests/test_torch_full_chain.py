"""The port's chain scripts on the CPU: ``scripts/full_chain.py``'s clip
maker, container round trip, vote and thresholds, ``scripts/e2e_demo.py``'s
dataset, and the whole ``full_chain --tiny --device cpu`` run (marked
``slow``: its host tracker alone reads ~33 ms a frame over ~4,000 frames on
a CPU host, minutes in all).
"""

import os
import wave

import numpy as np
import pytest

cv2 = pytest.importorskip("cv2")

from mmer_tpu_torch.scripts import e2e_demo, full_chain


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
