"""The PyTorch port's engine entry points against the JAX package's.

``predict_chunks`` and ``infer_sequence`` are held to the same computation
composed from the JAX package's pieces (its ``VideoFeatureExtractor``,
``AudioEmbedder``, fusion model and ``window_audio_slices``, following
``InferenceEngine.predict_clip`` and the window stage of
``infer_video_file``), at tiny float32 configs with the JAX params carried
into the port.  Inputs come from ``np.random.default_rng``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import mmer_tpu.config as jax_config
from mmer_tpu.core.buckets import batch_bucket
from mmer_tpu.models.fusion import MultimodalEmotionModel as JaxFusion
from mmer_tpu.models.wav2vec2 import AudioEmbedder as JaxAudioEmbedder
from mmer_tpu.preprocess.extract import VideoFeatureExtractor as JaxVideoExtractor
from mmer_tpu.serve.engine import window_audio_slices as jax_window_audio_slices
import mmer_tpu_torch.config as port_config
from mmer_tpu_torch.models.convert import (fusion_from_flax, vivit_from_flax,
                                           wav2vec2_from_flax)
from mmer_tpu_torch.models.wav2vec2 import AudioEmbedder
from mmer_tpu_torch.preprocess.extract import VideoFeatureExtractor
from mmer_tpu_torch.serve.engine import InferenceEngine, window_audio_slices

from test_torch_models import FUSION_KW, VIVIT_KW, W2V2_KW

CPU = torch.device("cpu")
SR = 16000


def _np_tree(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


@pytest.fixture(scope="module")
def pieces(tmp_path_factory):
    """The JAX pieces and a port engine holding the same weights."""
    vext = JaxVideoExtractor(jax_config.ViViTConfig(**VIVIT_KW), device_batch=2,
                             use_flash=False)
    audio = JaxAudioEmbedder(jax_config.Wav2Vec2Config(**W2V2_KW),
                             use_pallas=False)
    fcfg = jax_config.ModelConfig(**FUSION_KW)
    fusion = JaxFusion(fcfg)
    fparams = fusion.init(jax.random.PRNGKey(0), jnp.zeros((1, 3, 64)),
                          jnp.zeros((1, 32)), jnp.zeros((1, 3), bool))
    fparams = jax.tree_util.tree_map(
        lambda a: a + 0.05 * np.random.default_rng(7).normal(
            size=a.shape).astype(np.float32), _np_tree(fparams))

    ckpt = tmp_path_factory.mktemp("fusion") / "fusion.pth"
    torch.save(fusion_from_flax(fparams), ckpt)
    engine = InferenceEngine(
        CPU, model_cfg=port_config.ModelConfig(**FUSION_KW),
        vivit_cfg=port_config.ViViTConfig(**VIVIT_KW),
        wav_cfg=port_config.Wav2Vec2Config(**W2V2_KW),
        fusion_params_path=str(ckpt))
    engine._video_extractor = VideoFeatureExtractor(
        engine.vivit_cfg, device=CPU, device_batch=2,
        params=vivit_from_flax(_np_tree(vext.params)))
    engine._audio_embedder = AudioEmbedder(
        engine.wav_cfg, device=CPU, params=wav2vec2_from_flax(_np_tree(audio.params)))
    return vext, audio, fusion, fparams, engine


def _jax_probs(fusion, fparams, video, audio, mask):
    probs, _, _ = fusion.apply(fparams, jnp.asarray(video, jnp.float32),
                               jnp.asarray(audio, jnp.float32), jnp.asarray(mask))
    return np.asarray(probs)


def _chunks(rng, n):
    return rng.integers(0, 256, size=(n, 8, 32, 32, 3), dtype=np.uint8)


@pytest.mark.parametrize("n_chunks,audio_s", [(2, 0.7), (5, 0.3), (1, None)])
def test_predict_chunks_matches_jax(pieces, n_chunks, audio_s):
    """Fewer chunks than video slots (padded + masked), more (clipped), and
    no audio track (zero embedding)."""
    vext, audio, fusion, fparams, engine = pieces
    rng = np.random.default_rng(n_chunks)
    chunks = _chunks(rng, n_chunks)
    wave = (None if audio_s is None else
            rng.normal(size=(int(audio_s * SR),)).astype(np.float32))

    # JAX: InferenceEngine.predict_clip after decoding.
    feats = vext.embed_chunks(chunks)
    a = (audio.embed_batch([wave])[0] if wave is not None
         else np.zeros(32, np.float32))
    slots = FUSION_KW["max_seq_len"] - 1
    t = feats.shape[0]
    if t > slots:
        feats, mask = feats[:slots], np.zeros((1, slots), bool)
    else:
        feats = np.concatenate([feats, np.zeros((slots - t, 64), np.float32)])
        mask = np.arange(slots)[None, :] >= t
    want = _jax_probs(fusion, fparams, feats[None], a[None], mask)[0]

    got = engine.predict_chunks(chunks, wave)
    np.testing.assert_allclose(got["probabilities"], want, atol=2e-5)
    assert got["predicted_index"] == int(np.argmax(want))
    assert got["predicted_label"] == port_config.LABELS[int(np.argmax(want))]
    assert len(got["scores"]) == 3


def test_infer_sequence_matches_jax(pieces):
    """Five subchunks of 8 frames with a dropped-frame gap, windows of up to
    3 subchunks (the fusion model's slots), audio per window in one batch,
    windows grouped by token count with batch bucketing."""
    vext, audio, fusion, fparams, engine = pieces
    rng = np.random.default_rng(11)
    n_sub, sub, fps = 5, 8, 30.0
    subchunks = _chunks(rng, n_sub)
    frames = list(range(0, 20)) + list(range(24, 44))     # a 4-frame gap
    wave = rng.normal(size=(int(2.0 * SR),)).astype(np.float32)

    # JAX: the window stage of InferenceEngine.infer_video_file.
    sub_feats = vext.embed_chunks(subchunks)
    win = FUSION_KW["max_seq_len"] - 1
    win_lens = [min(win, n_sub - s) for s in range(n_sub)]
    waves = []
    for lo, hi in jax_window_audio_slices(frames, win_lens, sub, fps, SR):
        piece = wave[lo:hi]
        waves.append(piece if len(piece) else np.zeros(1, np.float32))
    audio_embs = audio.embed_batch(waves)
    want = np.zeros((n_sub, 6), np.float32)
    for wl in sorted(set(win_lens)):
        starts = [s for s, w in enumerate(win_lens) if w == wl]
        v = np.stack([sub_feats[s:s + wl] for s in starts])
        a = audio_embs[starts]
        bp = batch_bucket(len(starts))
        v = np.concatenate([v, np.repeat(v[-1:], bp - len(starts), axis=0)])
        a = np.concatenate([a, np.repeat(a[-1:], bp - len(starts), axis=0)])
        want[starts] = _jax_probs(fusion, fparams, v, a,
                                  np.zeros((bp, wl), bool))[:len(starts)]

    got = engine.infer_sequence(subchunks, frames, wave, fps, window_size=5)
    np.testing.assert_allclose(np.asarray(got["probabilities"]), want, atol=2e-5)
    assert [it["class"] for it in got["inference"]] == \
        [port_config.LABELS[i] for i in np.argmax(want, axis=1)]
    assert [it["frame"] for it in got["inference"]] == \
        [frames[s * sub] if s * sub < len(frames) else 0 for s in range(n_sub)]


@pytest.mark.parametrize("frames,win_lens,sub,fps", [
    (list(range(160)), [5, 4, 3, 2, 1], 32, 30.0),
    (list(range(0, 50)) + list(range(57, 70)), [2, 2, 1], 24, 25.0),
    ([3], [1], 32, 29.97),
])
def test_window_audio_slices_matches_jax(frames, win_lens, sub, fps):
    assert window_audio_slices(frames, win_lens, sub, fps, SR) == \
        jax_window_audio_slices(frames, win_lens, sub, fps, SR)


def test_embed_chunks_pads_to_device_batch(pieces, tmp_path):
    """An odd chunk count fills the last device batch by repetition; each
    row equals the chunk embedded alone, and a params .npz round-trips."""
    _, _, _, _, engine = pieces
    ext = engine.video_extractor
    chunks = _chunks(np.random.default_rng(4), 3)
    all3 = ext.embed_chunks(chunks)
    one = np.concatenate([ext.embed_chunks(chunks[i:i + 1]) for i in range(3)])
    np.testing.assert_allclose(all3, one, atol=1e-5)
    path = str(tmp_path / "vivit.npz")
    saved = VideoFeatureExtractor(engine.vivit_cfg, device=CPU, device_batch=2,
                                  params_path=path)      # writes seeded weights
    loaded = VideoFeatureExtractor(engine.vivit_cfg, device=CPU,
                                   params_path=path)
    np.testing.assert_array_equal(saved.embed_chunks(chunks),
                                  loaded.embed_chunks(chunks))


def test_engine_cuda_raises_without_cuda():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="CUDA"):
        InferenceEngine("cuda")


def test_engine_missing_fusion_checkpoint_raises(tmp_path):
    engine = InferenceEngine(CPU, fusion_params_path=str(tmp_path / "none.pth"))
    with pytest.raises(FileNotFoundError):
        _ = engine.fusion
