"""The port's ``/infer`` serving path against the JAX package's, on the CPU.

Tiny float32 configs (``tests/test_serve.py``'s ViViT and fusion, a tiny
Wav2Vec2 at the fusion model's 1024 audio width).  The JAX engine's seeded
weights are carried into the port (``models/convert.py``); the upload is a
grace_hopper face video (cv2's mp4v) with a seeded PCM audio track, so the
detector fires and the audio slices reach Wav2Vec2.  Tolerances are stated
at each test.
"""

import dataclasses
import json
import threading
import urllib.error
import urllib.request
from http.server import ThreadingHTTPServer

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

cv2 = pytest.importorskip("cv2")

import mmer_tpu.config as jax_config
from mmer_tpu.core.buckets import resolution_bucket as jax_resolution_bucket
from mmer_tpu.interpret.ig import integrated_gradients_impl
from mmer_tpu.models.fusion import MultimodalEmotionModel as JaxFusion
from mmer_tpu.models.port_fusion import load_pth as jax_load_pth
from mmer_tpu.models.port_fusion import save_pth as jax_save_pth
from mmer_tpu.ops.image import crop_resize_batch as jax_crop_resize_batch
from mmer_tpu.preprocess.extract import VideoFeatureExtractor as JaxVideoExtractor
from mmer_tpu.preprocess.faces import group_face_sequences as jax_group
from mmer_tpu.serve import app as jax_app
from mmer_tpu.serve import engine as jax_engine_mod
from mmer_tpu.serve.pcm_mp4 import mux_pcm_into_file
from mmer_tpu.train.checkpoint import save_params_msgpack
import mmer_tpu_torch.config as port_config
from mmer_tpu_torch.core.buckets import RESOLUTION_LADDER, resolution_bucket
from mmer_tpu_torch.interpret.ig import (aggregate_importances,
                                         compute_attributions,
                                         integrated_gradients)
from mmer_tpu_torch.models import port_fusion
from mmer_tpu_torch.models.convert import (fusion_from_flax, vivit_from_flax,
                                           wav2vec2_from_flax)
from mmer_tpu_torch.models.fusion import MultimodalEmotionModel
from mmer_tpu_torch.models.wav2vec2 import AudioEmbedder
from mmer_tpu_torch.ops.image import crop_resize_batch, resize_batch
from mmer_tpu_torch.preprocess.extract import (SubchunkStream,
                                               VideoFeatureExtractor)
from mmer_tpu_torch.preprocess.faces import group_face_sequences
from mmer_tpu_torch.serve import app as port_app
from mmer_tpu_torch.serve import engine as port_engine_mod
from mmer_tpu_torch.serve.engine import InferenceEngine

from test_torch_models import FUSION_KW
from torch_threads import few_threads  # noqa: F401

CPU = torch.device("cpu")
VIVIT_KW = dict(image_size=(32, 32), patch_size=(16, 16), num_frames=4,
                tubelet_size=2, dim=768, depth=1, heads=2, dim_head=32,
                mlp_dim=64, compute_dtype="float32")
SERVE_FUSION_KW = dict(max_seq_len=3, fusion_layers=1, compute_dtype="float32")
WAV_KW = dict(hidden_dim=1024, num_layers=1, num_heads=2, ffn_dim=64,
              conv_dims=(16, 16), conv_strides=(5, 2), conv_kernels=(10, 3),
              num_conv_pos_embeddings=16, num_conv_pos_embedding_groups=4,
              compute_dtype="float32")
SUB, WIN = 4, 2


def _np_tree(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _face_frames(n, gap=()):
    """``n`` RGB frames of grace_hopper at 300x256 with seeded ±8 jitter;
    frames in ``gap`` hold no face (a smooth gray card)."""
    pytest.importorskip("matplotlib")
    from matplotlib import cbook
    from PIL import Image

    img = cv2.resize(np.asarray(Image.open(
        cbook.get_sample_data("grace_hopper.jpg", asfileobj=False))), (256, 300))
    rng = np.random.default_rng(0)
    out = []
    for i in range(n):
        jitter = img.astype(np.int16) + rng.integers(-8, 8, img.shape)
        frame = np.clip(jitter, 0, 255).astype(np.uint8)
        out.append(np.full_like(frame, 128) if i in gap else frame)
    return out


def _write_video(path, frames, seconds_of_audio):
    w = cv2.VideoWriter(path, cv2.VideoWriter_fourcc(*"mp4v"), 30.0,
                        (256, 300))
    if not w.isOpened():
        pytest.skip("no mp4 encoder")
    for f in frames:
        w.write(f[:, :, ::-1])
    w.release()
    if seconds_of_audio:
        rng = np.random.default_rng(1)
        wave = (rng.normal(size=int(seconds_of_audio * 16000)) * 0.1
                ).astype(np.float32)
        mux_pcm_into_file(path, wave, 16000)
    return path


@pytest.fixture(scope="module")
def videos(tmp_path_factory):
    d = tmp_path_factory.mktemp("serve")
    return {
        # 12 face frames: 3 subchunks of 4, windows of 2 / 2 / 1.
        "face": _write_video(str(d / "face.mp4"), _face_frames(12), 0.5),
        # A 12-frame gap splits two sequences (gaps of more than 10).
        "gap": _write_video(str(d / "gap.mp4"),
                            _face_frames(28, gap=range(8, 20)), 1.0),
    }


@pytest.fixture(scope="module")
def engines():
    """A JAX engine and a port engine holding the same weights."""
    jcfg = (jax_config.ViViTConfig(**VIVIT_KW),
            jax_config.ModelConfig(**SERVE_FUSION_KW),
            jax_config.Wav2Vec2Config(**WAV_KW))
    jeng = jax_engine_mod.InferenceEngine(vivit_cfg=jcfg[0], model_cfg=jcfg[1],
                                          wav_cfg=jcfg[2])
    peng = _port_engine(jeng)
    return jeng, peng


def _port_engine(jeng, fusion_params_path=None, **kw):
    peng = InferenceEngine(
        CPU, vivit_cfg=port_config.ViViTConfig(**VIVIT_KW),
        model_cfg=port_config.ModelConfig(**SERVE_FUSION_KW),
        wav_cfg=port_config.Wav2Vec2Config(**WAV_KW),
        fusion_params_path=fusion_params_path, **kw)
    peng._video_extractor = VideoFeatureExtractor(
        peng.vivit_cfg, device=CPU,
        params=vivit_from_flax(_np_tree(jeng.video_extractor.params)))
    peng._audio_embedder = AudioEmbedder(
        peng.wav_cfg, device=CPU,
        params=wav2vec2_from_flax(_np_tree(jeng.audio_embedder.params)))
    if fusion_params_path is None:
        _, params, _ = jeng.fusion
        peng._fusion = MultimodalEmotionModel(peng.model_cfg, device=CPU)
        peng._fusion.load_state_dict(fusion_from_flax(_np_tree(params)))
    return peng


def _same_response(got, want, tol=1e-3):
    """Identical boxes, classes and frames; importances within ``tol``
    relative (of the largest |importance| of the list) by dimension."""
    assert set(got) == set(want) == {"bounding_box", "inference"}
    assert got["bounding_box"] == want["bounding_box"]
    assert len(got["inference"]) == len(want["inference"])
    for g, w in zip(got["inference"], want["inference"]):
        assert (g["class"], g["frame"]) == (w["class"], w["frame"])
        assert set(g) == set(w)
        if "feature_importance" not in w:
            continue
        for mod in ("video", "audio"):
            gi = {e["dimension"]: e["importance"]
                  for e in g["feature_importance"][mod]}
            wi = {e["dimension"]: e["importance"]
                  for e in w["feature_importance"][mod]}
            assert len(gi) == len(wi) == 10
            scale = max(abs(v) for v in wi.values())
            shared = set(gi) & set(wi)
            assert len(shared) >= 9, (mod, gi, wi)     # a tie at the 10th
            for dim in shared:
                assert abs(gi[dim] - wi[dim]) <= tol * scale, (mod, dim)


# -- host pieces ------------------------------------------------------------------

def test_resolution_bucket_matches_jax():
    assert RESOLUTION_LADDER == (160, 240, 320, 480, 640, 720, 960, 1280, 1920)
    for h in list(range(1, 2100, 37)) + [1920, 1921, 4000]:
        for w in (1, 159, 160, 161, 640, 1080, 1920, 2500, 3840):
            assert resolution_bucket(h, w) == jax_resolution_bucket(h, w)


@pytest.mark.parametrize("hw", [(300, 256), (480, 640), (2000, 1000)])
def test_canonicalize_frame_matches_jax(hw):
    """The pad branch, an exact rung, and the downscale (cv2) branch."""
    rng = np.random.default_rng(hw[0])
    rgb = rng.integers(0, 256, (*hw, 3), dtype=np.uint8)
    box = np.asarray([[10.5, 20.0, 200.0, 250.0]], np.float32)
    got = port_engine_mod.canonicalize_frame(rgb, box)
    want = jax_engine_mod.canonicalize_frame(rgb, box)
    np.testing.assert_array_equal(got[0], want[0])
    np.testing.assert_array_equal(got[1], want[1])


BOXES = np.asarray([[2, 3, 200, 250],          # inside
                    [-40, -30, 120, 90],       # off the top left
                    [180, 250, 300, 340],      # off the bottom right
                    [50.25, 60.5, 50.75, 160],  # thinner than a pixel
                    [10, 100.4, 240, 100.6],   # flatter than a pixel
                    [0, 0, 256, 300]], np.float32)


@pytest.mark.parametrize("out_hw", [(32, 32), (224, 224)])
def test_crop_resize_batch_matches_jax(out_hw):
    """f32 crops within 1e-3 on the 0-255 scale (the port rounds the
    sampling positions as XLA's compiled function does); after the
    truncating uint8 cast, at most 1 apart on under 0.1 % of values
    (found: none at 32², 1 of 903,168 at 224²)."""
    rng = np.random.default_rng(0)
    frames = rng.integers(0, 256, (len(BOXES), 300, 256, 3), dtype=np.uint8)
    want = np.asarray(jax_crop_resize_batch(jnp.asarray(frames),
                                            jnp.asarray(BOXES), out_hw=out_hw))
    got = crop_resize_batch(torch.from_numpy(frames), torch.from_numpy(BOXES),
                            out_hw).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-3)
    q_got = np.clip(got, 0, 255).astype(np.uint8).astype(int)
    q_want = np.clip(want, 0, 255).astype(np.uint8).astype(int)
    share = float((q_got != q_want).mean())
    print(f"uint8 crops at {out_hw}: {share:.3e} of values differ")
    assert np.abs(q_got - q_want).max() <= 1
    assert share < 1e-3
    full = resize_batch(torch.from_numpy(frames[:2]).float(), out_hw).numpy()
    whole = np.tile(np.asarray([0, 0, 256, 300], np.float32), (2, 1))
    np.testing.assert_allclose(full, np.asarray(jax_crop_resize_batch(
        jnp.asarray(frames[:2]), jnp.asarray(whole), out_hw=out_hw)),
        rtol=0, atol=1e-3)


def test_group_sequences_slices_and_topk_match_jax():
    rng = np.random.default_rng(5)
    rows = []
    for f in sorted(rng.choice(200, 120, replace=False)):
        for _ in range(int(rng.integers(1, 3))):
            x, y = rng.random(2) * 100
            rows.append((int(f), x, y, x + 50, y + 60, float(rng.random())))
    for delay in (0, 3, 10):
        got = group_face_sequences(rows, max_delay=delay,
                                   max_frames_per_sequence=17)
        want = jax_group(rows, max_delay=delay, max_frames_per_sequence=17)
        assert [(s.frames, s.bboxes) for s in got] == \
            [(s.frames, s.bboxes) for s in want]
    frames = list(range(0, 20)) + list(range(27, 61))
    for sub, n_sub, win in ((4, 14, 5), (8, 7, 3), (32, 1, 5)):
        lens = [min(win, n_sub - s) for s in range(n_sub)]
        for fps in (30.0, 29.97, 12.5):
            assert port_engine_mod.window_audio_slices(
                frames, lens, sub, fps, 16000) == \
                jax_engine_mod.window_audio_slices(frames, lens, sub, fps, 16000)
    vi, ai = rng.normal(size=768), rng.normal(size=1024)
    assert port_engine_mod._topk_importance(vi, ai) == \
        jax_engine_mod._topk_importance(vi, ai)
    assert port_engine_mod._topk_importance(vi, ai, 3) == \
        jax_engine_mod._topk_importance(vi, ai, 3)


def test_subchunk_stream_matches_one_shot_and_jax():
    """Ragged pieces equal the one-shot crop path bit for bit, with at most
    one subchunk of raw frames and one device batch of crops held; both
    within 1e-4 relative L2 of the JAX extractor's features."""
    jex = JaxVideoExtractor(jax_config.ViViTConfig(**VIVIT_KW),
                            device_batch=2, use_flash=False)
    ex = VideoFeatureExtractor(port_config.ViViTConfig(**VIVIT_KW), device=CPU,
                               device_batch=2,
                               params=vivit_from_flax(_np_tree(jex.params)))
    rng = np.random.default_rng(0)
    n, h, w = 23, 48, 40                    # 23 frames, sub=4 → 6 subchunks
    frames = (rng.random((n, h, w, 3)) * 255).astype(np.uint8)
    bboxes = np.stack([np.asarray([2, 3, w - 4, h - 2], np.float32)] * n)
    bboxes[5] = [-3, -2, 30, 20]
    bboxes[17] = [10.2, 11.0, 10.7, 40]

    want = ex.embed_cropped_frames(frames, bboxes, 4)
    stream = SubchunkStream(ex, 4)
    i = 0
    for piece in (1, 3, 7, 2, 5, 4, 1):     # ragged pieces, sums to 23
        stream.add(frames[i:i + piece], bboxes[i:i + piece])
        i += piece
        assert len(stream._frames) < 4
        assert len(stream._crops) < ex.device_batch
        assert all(c.dtype == torch.uint8 for c in stream._crops)
    got = stream.finish()
    assert got.shape == want.shape == (6, 768)
    np.testing.assert_array_equal(got, want)
    ref = jex.embed_cropped_frames(frames, bboxes, 4)
    rel = np.linalg.norm(got - ref) / np.linalg.norm(ref)
    assert rel < 1e-4, rel
    empty = SubchunkStream(ex, 4)
    assert empty.finish().shape == (0, 768)


# -- Integrated Gradients ----------------------------------------------------------------

@pytest.fixture(scope="module")
def small_fusion():
    jcfg = jax_config.ModelConfig(**FUSION_KW)
    jmodel = JaxFusion(jcfg)
    params = jmodel.init(jax.random.PRNGKey(4), jnp.zeros((1, 3, 64)),
                         jnp.zeros((1, 32)), jnp.zeros((1, 3), bool))
    rng = np.random.default_rng(4)
    params = jax.tree_util.tree_map(
        lambda a: a + 0.05 * rng.normal(size=a.shape).astype(np.float32),
        _np_tree(params))
    pmodel = MultimodalEmotionModel(port_config.ModelConfig(**FUSION_KW),
                                    device=CPU)
    pmodel.load_state_dict(fusion_from_flax(params))
    return jmodel, params, pmodel


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.linalg.norm(a - b) / np.linalg.norm(b))


@pytest.mark.parametrize("method", ["gausslegendre", "riemann_right",
                                    "riemann_middle"])
def test_integrated_gradients_matches_jax(small_fusion, method):
    """f32 attributions within 1e-4 relative L2 of the JAX function's, for
    each quadrature rule, with a padding mask and explicit targets."""
    jmodel, params, pmodel = small_fusion
    rng = np.random.default_rng(1)
    v = rng.normal(size=(3, 3, 64)).astype(np.float32)
    a = rng.normal(size=(3, 32)).astype(np.float32)
    m = np.asarray([[False, False, False], [False, False, True],
                    [False, True, True]])
    t = np.asarray([0, 3, 5], np.int32)

    def jax_logits(p, v_, a_, m_):
        return jmodel.apply(p, v_, a_, m_)[1]

    want = integrated_gradients_impl(jax_logits, params, jnp.asarray(v),
                                     jnp.asarray(a), jnp.asarray(m),
                                     jnp.asarray(t), 20, method)
    got = integrated_gradients(lambda v_, a_, m_: pmodel(v_, a_, m_)[1],
                               torch.from_numpy(v), torch.from_numpy(a),
                               torch.from_numpy(m), torch.from_numpy(t),
                               20, method)
    for g, w in zip(got, want):
        assert _rel(g.numpy(), w) < 1e-4
    assert all(p.grad is None for p in pmodel.parameters())


def test_ig_completeness_and_default_target(small_fusion):
    """On a smooth function the attributions sum to logit_t(x) − logit_t(0)
    (50 Gauss-Legendre nodes: within 1e-5 of the logit gap; linear:
    exactly the gap up to f32 rounding).  The default target is the
    predicted class; aggregation sums |attr| over time.

    The fusion model itself is not held to completeness: a LayerNorm right
    after each bias-free input projection makes f(αx) nearly constant for α
    above ~1e-3 and steep below, which a 50-node rule does not resolve."""
    rng = np.random.default_rng(2)
    v = torch.from_numpy(rng.normal(size=(2, 3, 64)).astype(np.float32))
    a = torch.from_numpy(rng.normal(size=(2, 32)).astype(np.float32))
    wv = torch.from_numpy(rng.normal(size=(64, 6)).astype(np.float32) * 0.2)
    wa = torch.from_numpy(rng.normal(size=(32, 6)).astype(np.float32) * 0.2)

    def linear(v_, a_, m_):
        return v_.sum(1) @ wv + a_ @ wa

    def smooth(v_, a_, m_):
        return torch.tanh(linear(v_, a_, m_)) * 2.0 + linear(v_, a_, m_) ** 2

    for fn, tol in ((linear, 1e-5), (smooth, 1e-5)):
        av, aa = compute_attributions(fn, v, a)
        with torch.no_grad():
            logits = fn(v, a, None)
            base = fn(torch.zeros_like(v), torch.zeros_like(a), None)
        t = logits.argmax(-1)
        gap = (logits - base).gather(1, t[:, None])[:, 0]
        total = av.sum(dim=(1, 2)) + aa.sum(dim=1)
        assert torch.allclose(total, gap, rtol=0, atol=tol * float(gap.abs().max())), \
            (total, gap)
    _, _, pmodel = small_fusion
    with torch.no_grad():
        t = pmodel(v, a)[1].argmax(-1)
    av, aa = compute_attributions(lambda v_, a_, m_: pmodel(v_, a_, m_)[1], v, a)
    av_t, aa_t = integrated_gradients(lambda v_, a_, m_: pmodel(v_, a_, m_)[1],
                                      v, a, None, t)
    assert torch.equal(av, av_t) and torch.equal(aa, aa_t)
    vi, ai = aggregate_importances(av, aa)
    assert torch.allclose(vi, av.abs().sum(1)) and torch.equal(ai, aa.abs())


# -- reference checkpoints ------------------------------------------------------------------

def test_port_fusion_reference_keys_match_jax(small_fusion, tmp_path):
    """A reference v2 ``.pth`` → the port: probabilities within 1e-5 of JAX
    ``load_pth`` + apply; the round trip gives the same keys and bits."""
    jmodel, params, _ = small_fusion
    jcfg = jax_config.ModelConfig(**FUSION_KW)
    path = str(tmp_path / "ref.pth")
    jax_save_pth(path, params, jcfg)
    ref_sd = torch.load(path, weights_only=True)

    sd, cfg = port_fusion.load_pth(path, heads=FUSION_KW["fusion_heads"],
                                   compute_dtype="float32")
    assert cfg == port_config.ModelConfig(**FUSION_KW)
    model = MultimodalEmotionModel(cfg, device=CPU)
    model.load_state_dict(sd)
    rng = np.random.default_rng(3)
    v = rng.normal(size=(4, 3, 64)).astype(np.float32)
    a = rng.normal(size=(4, 32)).astype(np.float32)
    m = np.zeros((4, 3), bool)
    m[1, 2] = True
    jvars, _ = jax_load_pth(path, jcfg)
    want = np.asarray(jmodel.apply(jvars, v, a, m)[0])
    with torch.no_grad():
        got = model(torch.from_numpy(v), torch.from_numpy(a),
                    torch.from_numpy(m))[0].numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)

    back = port_fusion.state_dict_from_params(sd, cfg)
    assert list(back) == list(ref_sd) or set(back) == set(ref_sd)
    for k, val in ref_sd.items():
        assert back[k].dtype == torch.float32 and torch.equal(back[k], val), k
    out = str(tmp_path / "back.pth")
    port_fusion.save_pth(out, sd, cfg)
    again, _ = port_fusion.load_pth(out, cfg)
    assert all(torch.equal(again[k], sd[k]) for k in sd)
    assert port_fusion.is_reference_state_dict(ref_sd)
    assert not port_fusion.is_reference_state_dict(model.state_dict())


def test_port_fusion_refuses_mismatches(small_fusion, tmp_path):
    _, params, _ = small_fusion
    jcfg = jax_config.ModelConfig(**FUSION_KW)
    path = str(tmp_path / "ref.pth")
    jax_save_pth(path, params, jcfg)
    wrong = port_config.ModelConfig(**dict(FUSION_KW, max_seq_len=57))
    with pytest.raises(ValueError, match="mismatch") as got:
        port_fusion.load_pth(path, wrong)
    with pytest.raises(ValueError, match="mismatch") as want:
        jax_load_pth(path, jax_config.ModelConfig(**dict(FUSION_KW,
                                                         max_seq_len=57)))
    assert str(got.value) == str(want.value)
    with pytest.raises(NotImplementedError, match="v1 BatchNorm"):
        port_fusion.params_from_state_dict({"fusion.bn_video.weight": 0})
    with pytest.raises(KeyError):
        port_fusion.params_from_state_dict({"something.else": 0})
    with pytest.raises(ValueError, match="divisible"):
        port_fusion.load_pth(path, heads=3)


# -- the engine --------------------------------------------------------------------------

@pytest.mark.parametrize("name,explain", [("face", False), ("face", True),
                                          ("gap", False)])
def test_infer_video_file_matches_jax(engines, videos, name, explain):
    jeng, peng = engines
    want = jeng.infer_video_file(videos[name], SUB, WIN, explain=explain)
    got = peng.infer_video_file(videos[name], SUB, WIN, explain=explain)
    _same_response(got, want)
    n_items = {"face": 3, "gap": 4}[name]
    assert len(got["inference"]) == n_items
    timings = peng.last_timings
    assert timings["sequences"] == {"face": 1, "gap": 2}[name]
    assert (timings["ig"] > 0) == explain


def test_infer_video_file_detect_every_and_clamp(engines, videos, capsys):
    jeng, peng = engines
    want = jeng.infer_video_file(videos["gap"], SUB, 50, detect_every=3)
    got = peng.infer_video_file(videos["gap"], SUB, 50, detect_every=3)
    _same_response(got, want)
    assert "clamping" in capsys.readouterr().out
    assert peng.last_timings["detected_frames"] == 10


def test_infer_frames_is_the_array_level_path(engines, videos):
    """Decoded frames + waveform give infer_video_file's answer, plus the
    window probabilities; a clip without a face gives nothing."""
    from mmer_tpu_torch.preprocess.audio import extract_audio_track
    from mmer_tpu_torch.preprocess.video import iter_video_frames

    _, peng = engines
    fps, frames = iter_video_frames(videos["face"])
    wave = extract_audio_track(videos["face"])
    res = peng.infer_frames(frames, fps, wave, SUB, WIN)
    assert {k: res[k] for k in ("bounding_box", "inference")} == \
        peng.infer_video_file(videos["face"], SUB, WIN)
    probs = np.asarray(res["probabilities"])
    assert probs.shape == (3, 6) and np.allclose(probs.sum(-1), 1, atol=1e-5)
    blank = [np.full((300, 256, 3), 128, np.uint8)] * 6
    assert peng.infer_frames(iter(blank), 30.0, wave, SUB, WIN) == \
        {"bounding_box": [], "inference": [], "probabilities": []}


def test_predict_clip_and_file_bytes_match_jax(engines, videos):
    jeng, peng = engines
    want = jeng.predict_clip(videos["face"], subchunk_size=SUB)
    got = peng.predict_clip(videos["face"], subchunk_size=SUB)
    assert set(got) == set(want) == {"predicted_label", "predicted_index",
                                     "scores"}
    assert got["predicted_label"] == want["predicted_label"]
    assert [s["label"] for s in got["scores"]] == \
        [s["label"] for s in want["scores"]]
    np.testing.assert_allclose([s["probability"] for s in got["scores"]],
                               [s["probability"] for s in want["scores"]],
                               rtol=0, atol=1e-4)
    data = open(videos["gap"], "rb").read()
    _same_response(peng.infer_file_bytes(data, "gap.mp4", SUB, WIN),
                   jeng.infer_file_bytes(data, "gap.mp4", SUB, WIN))
    junk = b"\x00\xffnot-a-video\x13\x37" * 100
    assert peng.infer_file_bytes(junk, "junk.mp4") == \
        jeng.infer_file_bytes(junk, "junk.mp4") == \
        {"bounding_box": [], "inference": []}
    assert peng.predict_clip(str(videos["face"]) + ".missing") is None


def test_engine_loads_reference_and_port_checkpoints(engines, tmp_path):
    jeng, _ = engines
    model, params, _ = jeng.fusion
    cfg = jeng.model_cfg
    ref = str(tmp_path / "ref.pth")
    jax_save_pth(ref, params, cfg)
    own = str(tmp_path / "own.pth")
    torch.save(fusion_from_flax(_np_tree(params)), own)
    rng = np.random.default_rng(0)
    v = rng.normal(size=(3, 2, 768)).astype(np.float32)
    a = rng.normal(size=(3, 1024)).astype(np.float32)
    m = np.zeros((3, 2), bool)
    want = np.asarray(model.apply(params, v, a, m)[0])
    msgpack = str(tmp_path / "best.msgpack")
    save_params_msgpack(msgpack, params["params"])
    for path in (ref, own, msgpack):
        peng = _port_engine(jeng, fusion_params_path=path)
        np.testing.assert_allclose(peng._fusion_probs(v, a, m), want,
                                   rtol=0, atol=1e-5)
    wrong = InferenceEngine(CPU, model_cfg=port_config.ModelConfig(
        **dict(SERVE_FUSION_KW, max_seq_len=57)), fusion_params_path=ref)
    with pytest.raises(ValueError, match="mismatch"):
        _ = wrong.fusion
    # A flax checkpoint of another width is refused, naming the config.
    with pytest.raises(ValueError, match="does not fit the fusion config"):
        _ = InferenceEngine(CPU, fusion_params_path=msgpack).fusion
    other = str(tmp_path / "best.safetensors")
    open(other, "wb").close()
    with pytest.raises(ValueError, match=r"\.pth and flax \.msgpack"):
        _ = InferenceEngine(CPU, fusion_params_path=other).fusion
    with pytest.raises(FileNotFoundError):
        _ = InferenceEngine(CPU, model_cfg=port_config.ModelConfig(
            **SERVE_FUSION_KW), fusion_params_path=ref + ",nope.pth").fusion


def test_ensemble_serving_matches_jax(engines, tmp_path):
    """Two members (one reference .pth, one port .pth) against the JAX
    engine's two-member ensemble: mean probabilities within 1e-5, and the
    IG logits surrogate keeps its (B, C) contract."""
    jeng, _ = engines
    model = JaxFusion(jeng.model_cfg)
    t = jeng.model_cfg.max_seq_len - 1
    msgpacks, pths = [], []
    for i, seed in enumerate((3, 9)):
        variables = model.init({"params": jax.random.PRNGKey(seed)},
                               jnp.zeros((1, t, 768)), jnp.zeros((1, 1024)),
                               jnp.zeros((1, t), bool))
        p = str(tmp_path / f"seed{seed}.msgpack")
        save_params_msgpack(p, variables["params"])
        msgpacks.append(p)
        pth = str(tmp_path / f"seed{seed}.pth")
        if i == 0:
            jax_save_pth(pth, variables, jeng.model_cfg)
        else:
            torch.save(fusion_from_flax(_np_tree(variables)), pth)
        pths.append(pth)
    jens = jax_engine_mod.InferenceEngine(model_cfg=jeng.model_cfg,
                                          vivit_cfg=jeng.vivit_cfg,
                                          fusion_params_path=",".join(msgpacks))
    _, params, apply = jens.fusion
    rng = np.random.default_rng(0)
    v = rng.normal(size=(3, t, 768)).astype(np.float32)
    a = rng.normal(size=(3, 1024)).astype(np.float32)
    m = np.zeros((3, t), bool)
    m[2, 1] = True
    want_probs, want_logits, _ = apply(params, v, a, m)
    pens = _port_engine(jeng, fusion_params_path=",".join(pths))
    assert pens.fusion.members == 2
    np.testing.assert_allclose(pens._fusion_probs(v, a, m),
                               np.asarray(want_probs), rtol=0, atol=1e-5)
    lg = pens.fusion_logits_fn(torch.from_numpy(v), torch.from_numpy(a),
                               torch.from_numpy(m))
    np.testing.assert_allclose(lg.detach().numpy(), np.asarray(want_logits),
                               rtol=0, atol=1e-4)
    assert pens.fusion_logits_fn is pens.fusion_logits_fn
    vi, ai = pens._importances(v, a, m, np.asarray([0, 1, 2]))
    assert vi.shape == (3, 768) and ai.shape == (3, 1024)
    assert np.isfinite(vi).all() and np.isfinite(ai).all()


def test_engine_cuda_and_server_refuse_without_cuda(monkeypatch, tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    monkeypatch.setenv("MMER_FLAGSHIP_DIR", str(tmp_path / "none"))
    with pytest.raises(RuntimeError, match="CUDA"):
        port_app.main(["--port", "0"])


def test_resolve_default_fusion(tmp_path):
    """Like the JAX resolver: the flagship's flax .msgpack (or a .pth) next
    to its manifest; a checkpoint of another format raises."""
    assert port_app.resolve_default_fusion(str(tmp_path / "nope")) == \
        (None, None, None)
    d = tmp_path / "flagship"
    d.mkdir()
    (d / "manifest.json").write_text(json.dumps(
        {"checkpoint": "artifacts/flagship/flagship.msgpack",
         "model_config": {"max_seq_len": 6}}))
    assert port_app.resolve_default_fusion(str(d)) == (None, None, None)
    (d / "flagship.msgpack").write_bytes(b"\x80")
    assert port_app.resolve_default_fusion(str(d)) == (
        str(d / "flagship.msgpack"), None, {"max_seq_len": 6})
    (d / "manifest.json").write_text(json.dumps({"checkpoint": "flagship.bin"}))
    (d / "flagship.bin").write_bytes(b"\x80")
    with pytest.raises(RuntimeError, match="msgpack"):
        port_app.resolve_default_fusion(str(d))
    (d / "manifest.json").write_text(json.dumps(
        {"checkpoint": "flagship.pth", "model_config": {"max_seq_len": 6}}))
    (d / "flagship.pth").write_bytes(b"\x80")
    np.savez(d / "norm_stats.npz", video_mean=np.zeros(2))
    assert port_app.resolve_default_fusion(str(d)) == (
        str(d / "flagship.pth"), str(d / "norm_stats.npz"), {"max_seq_len": 6})
    (d / "manifest.json").write_text("{not json")
    assert port_app.resolve_default_fusion(str(d)) == (None, None, None)


# -- HTTP ----------------------------------------------------------------------------------

@pytest.fixture(scope="module")
def servers(engines):
    """The JAX app and the port's, each over its engine, on 127.0.0.1."""
    out, started = [], []
    for mod, eng in zip((jax_app, port_app), engines):
        for limit in (mod.DEFAULT_MAX_UPLOAD_BYTES, 64):
            httpd = ThreadingHTTPServer(("127.0.0.1", 0),
                                        mod.make_handler(eng, limit))
            threading.Thread(target=httpd.serve_forever, daemon=True).start()
            started.append(httpd)
            out.append(f"http://127.0.0.1:{httpd.server_address[1]}")
    yield {"jax": out[0], "jax_small": out[1], "port": out[2],
           "port_small": out[3]}
    for httpd in started:
        httpd.shutdown()
        httpd.server_close()


def _post(url, body, boundary="tb"):
    req = urllib.request.Request(
        url, data=body, method="POST",
        headers={"Content-Type": f"multipart/form-data; boundary={boundary}"})
    try:
        with urllib.request.urlopen(req) as r:
            return r.status, r.headers.get("Content-Type"), r.read()
    except urllib.error.HTTPError as e:
        return e.code, e.headers.get("Content-Type"), e.read()


def _multipart(payload, name="file", boundary="tb"):
    return (f"--{boundary}\r\nContent-Disposition: form-data; name=\"{name}\"; "
            f"filename=\"up.mp4\"\r\nContent-Type: video/mp4\r\n\r\n").encode() \
        + payload + f"\r\n--{boundary}--\r\n".encode()


def test_http_infer_matches_jax(servers, videos):
    body = _multipart(open(videos["face"], "rb").read())
    route = f"/infer/?subchunk_size={SUB}&window_size={WIN}&explain=true"
    j_code, _, j_body = _post(servers["jax"] + route, body)
    p_code, p_type, p_body = _post(servers["port"] + route, body)
    assert p_code == j_code == 200 and p_type == "application/json"
    _same_response(json.loads(p_body), json.loads(j_body))
    for path in ("/ping", "/health", "/"):
        with urllib.request.urlopen(servers["port"] + path) as r:
            got = r.read()
        with urllib.request.urlopen(servers["jax"] + path) as r:
            assert got == r.read()


def test_http_status_codes_match_jax(servers):
    from test_remux import make_flv
    from mmer_tpu_torch.serve.remux import flv_to_mp4

    cases = [("/infer/", b"--tb--", "jax", 422),
             ("/infer/", b"x" * 1024, "jax_small", 413),
             ("/remux/", _multipart(b"not an flv"), "jax", 415),
             ("/remux/", b"--tb--", "jax", 422),
             ("/nowhere", b"", "jax", 404)]
    for route, body, which, code in cases:
        want = _post(servers[which] + route, body)
        got = _post(servers[which.replace("jax", "port")] + route, body)
        assert got[0] == want[0] == code, route
        assert json.loads(got[2]).keys() == json.loads(want[2]).keys()
    flv = make_flv()
    code, ctype, mp4 = _post(servers["port"] + "/remux/", _multipart(flv))
    assert (code, ctype) == (200, "video/mp4") and mp4 == flv_to_mp4(flv)


def test_multipart_parser_matches_jax():
    import random

    rnd = random.Random(0)
    body = _multipart(b"\x00BINARY\r\n\r\n\xff")
    assert port_app.parse_multipart(body, "multipart/form-data; boundary=tb") \
        == jax_app.parse_multipart(body, "multipart/form-data; boundary=tb") \
        == {"file": ("up.mp4", b"\x00BINARY\r\n\r\n\xff")}
    for _ in range(200):
        soup = bytes(rnd.getrandbits(8) for _ in range(rnd.randint(0, 300)))
        ctype = rnd.choice(["multipart/form-data; boundary=x", "", "a; boundary=b"])
        results = []
        for mod in (jax_app, port_app):
            try:
                results.append(mod.parse_multipart(soup, ctype))
            except ValueError as e:
                results.append(("ValueError", str(e)))
        assert results[0] == results[1]
