"""The port's serving cold start against the JAX package's, on the CPU.

``InferenceEngine.warmup`` must make the JAX engine's calls, in its order and
at its shapes: the extractors' ``embed_chunks`` / ``embed_cropped_frames`` /
``embed_batch``, the fusion forward and IG are recorded on both engines
(tiny float32 configs, the same weights) and the two lists compared.  After a
warmup the port answers as JAX does (``test_torch_serve._same_response``),
puts the launch counters back and, on a sample without a face, prints JAX's
WARNING.  The server's three ``--warmup*`` flags parse and fail as JAX's do,
and the ports of ``scripts/bench_serving.py`` and ``scripts/bench_extract.py``
keep the JAX script's upload maker, ``pctl`` and JSON keys.  The card's side
(no build after warmup, the kernels launched) is
``tests/test_torch_cuda.py``'s and ``chip_smoke.py``'s phase 4c.
"""

import contextlib
import json
import sys

import numpy as np
import pytest
import torch

cv2 = pytest.importorskip("cv2")

import mmer_tpu.config as jax_config
from mmer_tpu.serve import app as jax_app
from mmer_tpu.serve import engine as jax_engine_mod
import mmer_tpu_torch.config as port_config
from mmer_tpu_torch.core.buckets import resolution_bucket
from mmer_tpu_torch.models.convert import (fusion_from_flax, vivit_from_flax,
                                           wav2vec2_from_flax)
from mmer_tpu_torch.models.fusion import MultimodalEmotionModel
from mmer_tpu_torch.models.wav2vec2 import AudioEmbedder
from mmer_tpu_torch.ops import fused_blocks
from mmer_tpu_torch.ops.attention_variants import attention_variant
from mmer_tpu_torch.preprocess.extract import VideoFeatureExtractor
from mmer_tpu_torch.scripts import bench_extract, bench_serving
from mmer_tpu_torch.serve import app as port_app
from mmer_tpu_torch.serve.engine import InferenceEngine

from test_torch_serve import (VIVIT_KW, WAV_KW, _face_frames, _np_tree,
                              _same_response, _write_video)

_SAVED_PATH = list(sys.path)
import scripts.bench_serving as jax_bench_serving  # noqa: E402
sys.path[:] = _SAVED_PATH

CPU = torch.device("cpu")
# Four video slots, so that a window of 3 subchunks is served unclamped.
FUSION_KW = dict(max_seq_len=4, fusion_layers=1, compute_dtype="float32")
SUB = 4
# The scripts' shapes are the JAX scripts' (32-frame subchunks, 3 s clips,
# windows up to 6 s): a 32-wide Wav2Vec2 at a 40x stride keeps them cheap on
# the CPU, and the fusion model takes its 32-wide embeddings.
SCRIPT_WAV_KW = dict(WAV_KW, hidden_dim=32, conv_dims=(16, 16, 16, 16),
                     conv_strides=(5, 2, 2, 2), conv_kernels=(10, 3, 3, 3))


@pytest.fixture(scope="module")
def engines():
    """A JAX engine and a port engine holding the same weights."""
    jeng = jax_engine_mod.InferenceEngine(
        vivit_cfg=jax_config.ViViTConfig(**VIVIT_KW),
        model_cfg=jax_config.ModelConfig(**FUSION_KW),
        wav_cfg=jax_config.Wav2Vec2Config(**WAV_KW))
    peng = InferenceEngine(
        CPU, vivit_cfg=port_config.ViViTConfig(**VIVIT_KW),
        model_cfg=port_config.ModelConfig(**FUSION_KW),
        wav_cfg=port_config.Wav2Vec2Config(**WAV_KW))
    peng._video_extractor = VideoFeatureExtractor(
        peng.vivit_cfg, device=CPU,
        params=vivit_from_flax(_np_tree(jeng.video_extractor.params)))
    peng._audio_embedder = AudioEmbedder(
        peng.wav_cfg, device=CPU,
        params=wav2vec2_from_flax(_np_tree(jeng.audio_embedder.params)))
    _, params, _ = jeng.fusion
    peng._fusion = MultimodalEmotionModel(peng.model_cfg, device=CPU)
    peng._fusion.load_state_dict(fusion_from_flax(_np_tree(params)))
    return jeng, peng


@pytest.fixture(scope="module")
def clips(tmp_path_factory):
    d = tmp_path_factory.mktemp("warmup")
    return {
        # 12 face frames: 3 subchunks of 4, windows of up to 3.
        "face": _write_video(str(d / "face.mp4"), _face_frames(12), 0.5),
        "blank": _write_video(str(d / "blank.mp4"),
                              _face_frames(8, gap=range(8)), 0.3),
    }


def _shape(x):
    return tuple(int(n) for n in np.shape(x))


def _dtype(x):
    return str(x.dtype).replace("torch.", "")


@contextlib.contextmanager
def recording(eng, is_jax: bool):
    """Record ``(stage, shapes)`` of every extractor, fusion and IG call of
    ``eng`` while the block runs."""
    calls = []
    ve, ae = eng.video_extractor, eng.audio_embedder
    patched = []

    def wrap(obj, name, stage, shapes):
        fn = getattr(obj, name)

        def rec(*args, **kw):
            calls.append((stage, shapes(*args, **kw)))
            return fn(*args, **kw)

        setattr(obj, name, rec)
        patched.append((obj, name))

    wrap(ve, "embed_chunks", "embed_chunks",
         lambda x, *a, **k: (_shape(x), _dtype(x)))
    wrap(ve, "embed_cropped_frames", "embed_cropped_frames",
         lambda f, b, sub: (_shape(f), _dtype(f), _shape(b), sub))
    wrap(ae, "embed_batch", "embed_batch",
         lambda waves: tuple(len(w) for w in waves))
    if is_jax:
        saved = eng._fusion, eng._ig_fn
        model, params, apply = eng.fusion
        ig = eng.ig_fn

        def rec_apply(p, v, a, m):
            calls.append(("fusion", (_shape(v), _shape(a), _shape(m))))
            return apply(p, v, a, m)

        def rec_ig(p, v, a, m, t):
            calls.append(("ig", (_shape(v), _shape(a), _shape(m), _shape(t))))
            return ig(p, v, a, m, t)

        eng._fusion, eng._ig_fn = (model, params, rec_apply), rec_ig
    else:
        wrap(eng, "_fusion_probs", "fusion",
             lambda v, a, m: (_shape(v), _shape(a), _shape(m)))
        wrap(eng, "_importances", "ig",
             lambda v, a, m, t: (_shape(v), _shape(a), _shape(m), _shape(t)))
    try:
        yield calls
    finally:
        for obj, name in patched:
            delattr(obj, name)
        if is_jax:
            eng._fusion, eng._ig_fn = saved


# (window_size, fps, explain, resolutions): two formats in the (320, 320)
# bucket and one in (640, 720); at 8 fps a 3-subchunk window needs the 2 s
# Wav2Vec2 bucket.
CASES = [
    (2, 30.0, True, [(300, 256), (310, 280), (500, 700)]),
    (3, 8.0, True, []),
    (3, 30.0, False, [(480, 640)]),
]


@pytest.mark.parametrize("window,fps,explain,resolutions", CASES)
def test_warmup_makes_jax_calls_at_jax_shapes(engines, window, fps, explain,
                                              resolutions, capsys):
    jeng, peng = engines
    kw = dict(subchunk_size=SUB, window_size=window, explain=explain,
              resolutions=resolutions, fps=fps)
    with recording(jeng, True) as want:
        jeng.warmup(**kw)
    with recording(peng, False) as got:
        peng.warmup(**kw)
    assert got == want
    stages = [s for s, _ in got]
    assert stages.count("fusion") == window
    assert stages.count("ig") == (window if explain else 0)
    assert len({shape for s, shape in got if s == "embed_cropped_frames"}) == \
        len({resolution_bucket(h, w) for h, w in resolutions})
    # The port's printout: a line a phase, then the total.
    lines = capsys.readouterr().out.splitlines()
    phases = peng.last_warmup["phases"]
    assert lines[-1].startswith("engine warmup complete in")
    assert [line.split("s  ", 1)[1] for line in lines[-1 - len(phases):-1]] \
        == [name for name, _ in phases]


def test_warmup_sample_replays_the_jax_request(engines, clips):
    """A sample upload (bytes, decoded with cv2) or the same sample decoded
    (``sample_frames``) is replayed as JAX replays its upload, and the
    requests after the warmup answer as JAX's do."""
    from mmer_tpu_torch.preprocess.audio import extract_audio_track
    from mmer_tpu_torch.preprocess.video import iter_video_frames

    jeng, peng = engines
    data = open(clips["face"], "rb").read()
    kw = dict(subchunk_size=SUB, window_size=3, fps=30.0)
    with recording(jeng, True) as want:
        jeng.warmup(sample_upload=data, **kw)
    with recording(peng, False) as got:
        peng.warmup(sample_upload=data, **kw)
    assert got == want
    fps, frames = iter_video_frames(clips["face"])
    wave = extract_audio_track(clips["face"])
    with recording(peng, False) as got_frames:
        peng.warmup(sample_frames=(frames, fps, wave), **kw)
    assert got_frames == want
    # A warmed engine answers as JAX's.
    for explain in (False, True):
        want_res = jeng.infer_video_file(clips["face"], SUB, 3, explain=explain,
                                         detect_every=3)
        fps, frames = iter_video_frames(clips["face"])
        got_res = peng.infer_frames(frames, fps, wave, SUB, 3, explain=explain,
                                    detect_every=3)
        _same_response({k: got_res[k] for k in ("bounding_box", "inference")},
                       want_res)
        assert len(got_res["inference"]) == 3
    with pytest.raises(ValueError, match="not both"):
        peng.warmup(sample_upload=data, sample_frames=([], 30.0, None), **kw)


def test_cold_engine_answers_its_first_explain_request(engines, clips):
    """Without a warmup the seeded fusion head (the JAX engine's PRNGKey(0)
    init) is made inside the first request, under its inference mode; that
    request's IG still differentiates through it and answers as JAX's."""
    jeng, peng = engines
    cold = InferenceEngine(CPU, vivit_cfg=peng.vivit_cfg,
                           model_cfg=peng.model_cfg, wav_cfg=peng.wav_cfg)
    cold._video_extractor = peng.video_extractor
    cold._audio_embedder = peng.audio_embedder
    got = cold.infer_video_file(clips["face"], SUB, 3, explain=True)
    _same_response(got, jeng.infer_video_file(clips["face"], SUB, 3,
                                              explain=True))
    assert all("feature_importance" in item for item in got["inference"])


def test_warmup_no_face_sample_prints_jax_warning(engines, clips, capsys):
    jeng, peng = engines
    data = open(clips["blank"], "rb").read()
    kw = dict(subchunk_size=SUB, window_size=2, explain=False)
    jeng.warmup(sample_upload=data, **kw)
    want = [l for l in capsys.readouterr().out.splitlines()
            if l.startswith("WARNING")]
    peng.warmup(sample_upload=data, **kw)
    got = [l for l in capsys.readouterr().out.splitlines()
           if l.startswith("WARNING")]
    blank = [np.full((300, 256, 3), 128, np.uint8)] * 8
    peng.warmup(sample_frames=(iter(blank), 30.0, None), **kw)
    got_frames = [l for l in capsys.readouterr().out.splitlines()
                  if l.startswith("WARNING")]
    assert len(want) == 1 and got == got_frames == want


def test_warmup_leaves_state_and_counters_as_found(engines):
    """The launch counters (ints and the probe's per-mode dict) and
    ``last_timings`` come back as they were, also when a phase raises; a
    CPU engine launches and builds nothing."""
    _, peng = engines
    fused_blocks.fused_ffn.launches = 7
    fused_blocks.fused_ffn.reduce_launches = 3
    attention_variant.launches["full"] = 5
    peng.last_timings = {"detect": 1.25}
    try:
        peng.warmup(subchunk_size=SUB, window_size=2, explain=False)
        assert (fused_blocks.fused_ffn.launches,
                fused_blocks.fused_ffn.reduce_launches,
                attention_variant.launches["full"]) == (7, 3, 5)
        assert peng.last_timings == {"detect": 1.25}
        assert set(peng.last_warmup["launches"].values()) == {0}
        assert peng.last_warmup["builds"] == 0
        assert peng.last_warmup["seconds"] >= sum(
            s for _, s in peng.last_warmup["phases"]) - 1e-6

        # A phase that launches and then fails: counters back, error raised.
        def failing(waves):
            fused_blocks.fused_ffn.launches += 24
            attention_variant.launches["full"] += 2
            raise RuntimeError("kernel failed")

        peng.audio_embedder.embed_batch = failing
        try:
            with pytest.raises(RuntimeError, match="kernel failed"):
                peng.warmup(subchunk_size=SUB, window_size=2)
        finally:
            del peng.audio_embedder.embed_batch
        assert (fused_blocks.fused_ffn.launches,
                attention_variant.launches["full"]) == (7, 5)
    finally:
        fused_blocks.fused_ffn.launches = 0
        fused_blocks.fused_ffn.reduce_launches = 0
        attention_variant.launches["full"] = 0


# -- the server's flags ---------------------------------------------------------

class _StubEngine:
    warmups = []

    def __init__(self, *args, **kw):
        pass

    def warmup(self, **kw):
        _StubEngine.warmups.append(kw)


def _run_main(side, argv, monkeypatch, capsys):
    """``side``'s server main on ``argv`` with a stub engine and no server:
    (the warmup kwargs or None, the exit code, the last stderr line)."""
    import mmer_tpu.core.cache as jax_cache

    _StubEngine.warmups = []
    mod = jax_app if side == "jax" else port_app
    monkeypatch.setattr(mod, "InferenceEngine", _StubEngine)
    monkeypatch.setattr(mod, "serve", lambda *a, **k: None)
    monkeypatch.setattr(mod, "resolve_default_fusion",
                        lambda *a, **k: (None, None, None))
    monkeypatch.setattr(jax_cache, "enable_persistent_cache", lambda: None)
    monkeypatch.setattr(sys, "argv", ["serve"] + argv)
    code = 0
    try:
        if side == "jax":
            mod.main()
        else:
            mod.main(argv + ["--device", "cpu"])
    except SystemExit as e:
        code = e.code
    err = capsys.readouterr().err.strip().splitlines()
    return ((_StubEngine.warmups or [None])[-1], code,
            err[-1] if err else "")


@pytest.mark.parametrize("argv", [
    [],
    ["--warmup"],
    ["--warmup_resolutions", "480x640, 720X1280"],
    ["--warmup_upload", "SAMPLE"],
    ["--warmup", "--warmup_resolutions", "300x256", "--warmup_upload", "SAMPLE"],
    ["--warmup_resolutions", "480by640"],
    ["--warmup_resolutions", "480x640,720"],
    ["--warmup_upload", "MISSING"],
], ids=["none", "warmup", "resolutions", "upload", "all", "bad-entry",
        "short-entry", "missing-file"])
def test_server_warmup_flags_match_jax(argv, tmp_path, monkeypatch, capsys):
    sample = tmp_path / "sample.mp4"
    sample.write_bytes(b"sample bytes")
    argv = [str(sample) if a == "SAMPLE" else
            str(tmp_path / "missing.mp4") if a == "MISSING" else a
            for a in argv]
    want = _run_main("jax", argv, monkeypatch, capsys)
    got = _run_main("port", argv, monkeypatch, capsys)
    assert got == want
    if any(a.startswith("--warmup") for a in argv) and want[1] == 0:
        assert got[0] is not None     # either of the last two implies --warmup
    if want[1]:
        assert want[1] == 2 and "error: --warmup" in want[2]


# -- the two scripts --------------------------------------------------------------

def test_bench_serving_copies_match_jax(tmp_path, monkeypatch):
    """``pctl`` and ``make_face_video`` (byte for byte, with and without the
    audio track, a resized and a pasted face) equal the JAX script's; the
    frames route's frames and waveform are the ones that video encodes."""
    rng = np.random.default_rng(0)
    xs = rng.random(17) * 1e3
    for p in (0, 5, 50, 95, 99.5, 100):
        assert bench_serving.pctl(xs, p) == jax_bench_serving.pctl(xs, p)
        assert bench_serving.pctl(list(xs[:3]), p) == \
            jax_bench_serving.pctl(list(xs[:3]), p)
    for i, (kw) in enumerate([dict(frames=5, seed=3),
                              dict(frames=4, seed=77, size=(310, 280)),
                              dict(frames=3, seed=1, audio=False)]):
        a, b = str(tmp_path / f"jax{i}.mp4"), str(tmp_path / f"port{i}.mp4")
        jax_bench_serving.make_face_video(a, **kw)
        bench_serving.make_face_video(b, **kw)
        assert open(a, "rb").read() == open(b, "rb").read()

    # What the JAX script hands its writer and its PCM muxer.
    import mmer_tpu.serve.pcm_mp4 as jax_pcm

    written, muxed = [], []

    class Writer:
        def __init__(self, *a):
            pass

        def isOpened(self):
            return True

        def write(self, bgr):
            written.append(bgr[:, :, ::-1].copy())

        def release(self):
            pass

    monkeypatch.setattr(cv2, "VideoWriter", Writer)
    monkeypatch.setattr(jax_pcm, "mux_pcm_into_file",
                        lambda path, wav, rate: muxed.append((wav, rate)))
    for size in ((256, 300), (310, 280), (700, 500)):
        written.clear()
        muxed.clear()
        jax_bench_serving.make_face_video("x.mp4", 6, seed=5, size=size)
        frames, wave = bench_serving.make_face_frames(6, 5, size=size)
        frames = list(frames)
        assert len(frames) == len(written) == 6
        np.testing.assert_array_equal(wave, muxed[0][0])
        assert muxed[0][1] == 16000
        for got, want in zip(frames, written):
            assert got.shape == want.shape == (size[1], size[0], 3)
            if size == (256, 300):
                np.testing.assert_array_equal(got, want)
            else:
                # The jittered grey canvas is the same; the pasted face is
                # the port's resize of the packaged one, not cv2's of the
                # original, at the same place.
                s = min(size[0] / 256, size[1] / 300)
                nw, nh = int(256 * s), int(300 * s)
                y0, x0 = (size[1] - nh) // 2, (size[0] - nw) // 2
                face = np.zeros(got.shape[:2], bool)
                face[y0:y0 + nh, x0:x0 + nw] = True
                np.testing.assert_array_equal(got[~face], want[~face])
                diff = np.abs(got[face].astype(int) - want[face].astype(int))
                assert diff.mean() < 4, diff.mean()
    frames, wave = bench_serving.make_face_frames(2, 5, audio=False)
    assert wave is None and len(list(frames)) == 2


def _tiny_serving_engine(device):
    # num_frames 32: the script serves 32-frame subchunks.
    return InferenceEngine(
        device, vivit_cfg=port_config.ViViTConfig(**dict(VIVIT_KW, num_frames=32)),
        wav_cfg=port_config.Wav2Vec2Config(**SCRIPT_WAV_KW),
        model_cfg=port_config.ModelConfig(audio_dim=32, fusion_layers=1,
                                          compute_dtype="float32"))


def _jax_json_keys(monkeypatch, capsys, argv):
    """The keys of the JAX script's JSON line, from its ``main`` on a stub
    engine and stub uploads."""
    import mmer_tpu.core.cache as jax_cache
    import mmer_tpu.serve.engine as jax_engine

    class Stub:
        def warmup(self, **kw):
            pass

        def infer_file_bytes(self, *a, **kw):
            return {"inference": [{"class": "NEU", "frame": 0}]}

    monkeypatch.setattr(jax_cache, "enable_persistent_cache", lambda: None)
    monkeypatch.setattr(jax_engine, "InferenceEngine", Stub)
    monkeypatch.setattr(jax_bench_serving, "make_face_video",
                        lambda path, *a, **k: open(path, "wb").write(b"x"))
    monkeypatch.setattr(sys, "argv", ["bench_serving"] + argv)
    jax_bench_serving.main()
    return set(json.loads(capsys.readouterr().out.strip().splitlines()[-1]))


@pytest.mark.parametrize("route,argv", [
    ("frames", ["--warmup_upload", "--warmup_resolutions", "300x256",
                "--long_upload_frames", "36"]),
    ("file", ["--no_warmup"]),
])
def test_bench_serving_runs_on_the_cpu(route, argv, monkeypatch, capsys):
    monkeypatch.setattr(bench_serving, "build_engine", _tiny_serving_engine)
    common = ["--requests", "1", "--frames", "32"]
    bench_serving.main(common + argv + ["--route", route, "--device", "cpu"])
    out, err = capsys.readouterr()
    res = json.loads(out.strip().splitlines()[-1])
    assert set(res) == _jax_json_keys(monkeypatch, capsys, common + argv) | {
        "route"}
    assert res["route"] == route and res["warmed"] == (route == "frames")
    assert res["first_request_s"] > 0 and res["explain_p50_ms"] > 0
    cold = json.loads(next(l for l in err.splitlines()
                           if l.startswith("cold start: "))[len("cold start: "):])
    assert cold["kernel_builds_after_warmup"] == 0
    if route == "frames":
        assert res["long_upload"]["frames"] == 36
        assert [p[0] for p in cold["warmup"]["phases"]][-1].startswith(
            "end-to-end sample request")
        assert any("crop route 320x320" in p[0]
                   for p in cold["warmup"]["phases"])


def test_scripts_refuse_cuda_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="CUDA"):
        bench_serving.main(["--route", "frames"])
    with pytest.raises(RuntimeError, match="CUDA"):
        bench_extract.main([])
    with pytest.raises(SystemExit):
        bench_serving.main(["--warmup_resolutions", "480", "--device", "cpu"])


def test_bench_extract_runs_on_the_cpu(capsys):
    res = bench_extract.main(
        ["--device", "cpu"],
        vivit_cfg=port_config.ViViTConfig(**VIVIT_KW),
        wav_cfg=port_config.Wav2Vec2Config(**SCRIPT_WAV_KW),
        model_cfg=port_config.ModelConfig(max_seq_len=6, fusion_layers=1,
                                          compute_dtype="float32"))
    lines = capsys.readouterr().out.strip().splitlines()
    assert json.loads(lines[-1]) == res
    assert [l.split(":")[0] for l in lines[1:5]] == [
        "vivit embed (uint8, B=16)", "wav2vec2-large embed",
        "viola-jones 224^2", "fusion inference"]
    for key in ("vivit_chunks_per_s", "vivit_frames_per_s", "w2v2_clips_per_s",
                "detector_ms_per_frame", "fusion_windows_per_s"):
        assert np.isfinite(res[key]) and res[key] > 0
    assert res["vivit_frames_per_s"] == pytest.approx(
        res["vivit_chunks_per_s"] * VIVIT_KW["num_frames"])
