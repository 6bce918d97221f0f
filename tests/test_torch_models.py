"""The PyTorch port's models against the JAX package's, on the CPU.

Tiny float32 configs (2 layers, widths ≤ 64, 8 frames of 32×32, the real
conv kernel/stride spec at 16 channels).  The JAX package's seeded params
are carried into the port by ``mmer_tpu_torch.models.convert``; inputs come
from ``np.random.default_rng``.  Tolerances cover float32 summation order
only (the port's GEMMs and reductions sum in another order than XLA's).
"""

import dataclasses
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import mmer_tpu.config as jax_config
from mmer_tpu.core.buckets import batch_bucket as jax_batch_bucket
from mmer_tpu.models.fusion import MultimodalEmotionModel as JaxFusion
from mmer_tpu.models.vivit import ViViTFeatureExtractor as JaxViViT
from mmer_tpu.models.wav2vec2 import AudioEmbedder as JaxAudioEmbedder
from mmer_tpu.models.wav2vec2 import EncoderLayer as JaxEncoderLayer
from mmer_tpu.models.wav2vec2 import Wav2Vec2Encoder as JaxWav2Vec2
import mmer_tpu_torch.config as port_config
from mmer_tpu_torch.core.buckets import batch_bucket
from mmer_tpu_torch.models.convert import (fusion_from_flax, vivit_from_flax,
                                           wav2vec2_from_flax)
from mmer_tpu_torch.models.fusion import (MultimodalEmotionModel, TokenNorm,
                                          init_fusion)
from mmer_tpu_torch.models.vivit import ViViTFeatureExtractor, init_vivit
from mmer_tpu_torch.models.wav2vec2 import (AudioEmbedder, Wav2Vec2Encoder,
                                            feat_extract_output_length,
                                            init_wav2vec2)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

VIVIT_KW = dict(image_size=(32, 32), patch_size=(16, 16), num_frames=8,
                tubelet_size=4, dim=64, depth=2, heads=2, dim_head=32,
                mlp_dim=128, compute_dtype="float32")
W2V2_KW = dict(hidden_dim=32, num_layers=2, num_heads=2, ffn_dim=64,
               conv_dims=(16, 16), conv_strides=(5, 2), conv_kernels=(10, 3),
               num_conv_pos_embeddings=16, num_conv_pos_embedding_groups=4,
               chunk_duration_s=0.5, compute_dtype="float32")
FUSION_KW = dict(video_dim=64, audio_dim=32, fused_dim=32, max_seq_len=4,
                 fusion_layers=2, fusion_heads=2, fusion_ffn_dim=64,
                 classifier_hidden_dim=32, compute_dtype="float32")
CPU = torch.device("cpu")


def _np_tree(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _bf16(kw):
    return dict(kw, compute_dtype="bfloat16")


def _perturbed(tree, seed):
    """Params moved off flax's init (zero biases, unit LayerNorms) so that
    a bias rounded at the wrong point shows."""
    rng = np.random.default_rng(seed)
    return jax.tree_util.tree_map(
        lambda a: (a + 0.1 * rng.normal(size=a.shape)).astype(np.float32),
        _np_tree(tree))


def _rel_l2(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.linalg.norm(a - b) / np.linalg.norm(b))


# -- package boundary --------------------------------------------------------

def test_import_loads_no_jax():
    """The port must run where JAX is not installed: importing every module
    of the package (serving, media, detection and IG included) loads
    neither jax, flax nor mmer_tpu."""
    code = ("import importlib, pkgutil, sys\n"
            "import mmer_tpu_torch\n"
            "names = [m.name for m in pkgutil.walk_packages(\n"
            "    mmer_tpu_torch.__path__, 'mmer_tpu_torch.')]\n"
            "for name in names:\n"
            "    importlib.import_module(name)\n"
            "assert 'mmer_tpu_torch.serve.app' in names, names\n"
            "assert 'mmer_tpu_torch.preprocess.cascade' in names, names\n"
            "assert 'mmer_tpu_torch.models.jax_init' in names, names\n"
            "assert 'mmer_tpu_torch.models.port_wav2vec2' in names, names\n"
            "for new in ('core.mesh', 'core.check', 'parallel.sharding',\n"
            "            'parallel.scaling', 'parallel.dryrun',\n"
            "            'parallel.launch', 'data.native_loader',\n"
            "            'data.streaming', 'train.streaming'):\n"
            "    assert 'mmer_tpu_torch.' + new in names, (new, names)\n"
            "bad = sorted(m for m in sys.modules\n"
            "             if m.split('.')[0] in ('jax', 'flax', 'mmer_tpu'))\n"
            "print(bad)\n"
            "sys.exit(1 if bad else 0)\n")
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stdout + proc.stderr


@pytest.mark.parametrize("name", ["ModelConfig", "ViViTConfig", "Wav2Vec2Config",
                                  "MeshConfig"])
def test_config_copy_matches_jax(name):
    """The copied dataclasses must not drift from mmer_tpu.config."""
    ours, theirs = getattr(port_config, name), getattr(jax_config, name)
    fo = [(f.name, f.type, f.default) for f in dataclasses.fields(ours)]
    ft = [(f.name, f.type, f.default) for f in dataclasses.fields(theirs)]
    assert fo == ft
    assert ours.__dataclass_params__.frozen == theirs.__dataclass_params__.frozen



@pytest.mark.parametrize("name", ["ModelConfig", "DataConfig", "TrainConfig",
                                  "MeshConfig", "ViViTConfig", "Wav2Vec2Config"])
def test_config_asdict_and_to_json_match_jax(name):
    """``config.asdict`` / ``config.to_json`` of every config equal the JAX
    package's on the same field values (the port's defaults, then with its
    feature folders and output directory set: the port's default paths
    differ from JAX's machine paths)."""
    ours, theirs = getattr(port_config, name), getattr(jax_config, name)
    paths = {f.name: f"/data/{f.name}" for f in dataclasses.fields(ours)
             if f.name.endswith(("_dir", "_path"))}
    for kw in ({}, paths):
        cfg = ours(**kw)
        jcfg = theirs(**port_config.asdict(cfg))
        assert port_config.asdict(cfg) == jax_config.asdict(jcfg)
        assert port_config.to_json(cfg) == jax_config.to_json(jcfg)


@pytest.mark.parametrize("heads", [None, 2])
def test_port_fusion_cli_matches_jax(tmp_path, capsys, heads):
    """``python -m mmer_tpu_torch.models.port_fusion``: a reference-layout
    ``.pth`` (tiny widths, values from a numpy seed) → the same ``.msgpack``
    bytes and report as the JAX CLI's from the same file, leaf for leaf
    equal; ``.msgpack`` → ``.pth`` gives the original state dict back, key
    for key and bit for bit, with the JAX CLI's report; ``--heads`` shapes
    the attention kernels."""
    from flax import serialization

    from mmer_tpu.models import port_fusion as jax_port_fusion
    from mmer_tpu_torch.models import port_fusion

    cfg = port_config.ModelConfig(**dict(FUSION_KW, fusion_heads=heads or 8))
    rng = np.random.default_rng(11)
    ours = {k: torch.from_numpy(rng.normal(size=v.shape).astype(np.float32))
            for k, v in MultimodalEmotionModel(cfg, device=CPU).state_dict().items()}
    ref = port_fusion.state_dict_from_params(ours, cfg)
    src = str(tmp_path / "ref.pth")
    torch.save(ref, src)
    flag = [] if heads is None else ["--heads", str(heads)]

    reports, trees = [], []
    for tag, cli in (("jax", jax_port_fusion.main), ("port", port_fusion.main)):
        dst = str(tmp_path / f"{tag}.msgpack")
        cli([src, dst] + flag)
        reports.append(capsys.readouterr().out.replace(dst, "DST"))
        with open(dst, "rb") as f:
            trees.append(f.read())
    assert reports[0] == reports[1]
    assert f"fusion_heads={heads or 8}" in reports[1]
    assert trees[0] == trees[1]
    want = serialization.msgpack_restore(trees[0])
    got = serialization.msgpack_restore(trees[1])
    assert jax.tree_util.tree_structure(got) == jax.tree_util.tree_structure(want)
    for a, b in zip(jax.tree_util.tree_leaves(got), jax.tree_util.tree_leaves(want)):
        assert a.dtype == b.dtype and np.array_equal(a, b)
    q = got["fusion"]["layer_0"]["self_attn"]["query"]["kernel"]
    assert q.shape == (32, heads or 8, 32 // (heads or 8))

    reports = []
    for tag, cli in (("jax", jax_port_fusion.main), ("port", port_fusion.main)):
        dst = str(tmp_path / f"{tag}.pth")
        cli([str(tmp_path / "port.msgpack"), dst] + flag)
        reports.append(capsys.readouterr().out.replace(dst, "DST"))
    assert reports[0] == reports[1]
    back = torch.load(str(tmp_path / "port.pth"), weights_only=True)
    theirs = torch.load(str(tmp_path / "jax.pth"), weights_only=True)
    assert list(back) == list(ref)
    for k, v in ref.items():
        assert back[k].dtype == torch.float32 and torch.equal(back[k], v), k
        assert torch.equal(theirs[k], v), k


def test_labels_and_batch_bucket_copies_match_jax():
    assert port_config.LABELS == jax_config.LABELS
    assert port_config.NUM_CLASSES == jax_config.NUM_CLASSES
    for n in range(0, 400):
        assert batch_bucket(n) == jax_batch_bucket(n)
        assert batch_bucket(n, 16) == jax_batch_bucket(n, 16)


# -- ViViT -------------------------------------------------------------------

@pytest.mark.parametrize("use_flash", [False, True])
def test_vivit_matches_jax(use_flash):
    """The port (plain versions of its kernels on the CPU) against the JAX
    ViViT on its XLA path and on its Pallas path in interpret mode."""
    jcfg = jax_config.ViViTConfig(**VIVIT_KW)
    model = JaxViViT(jcfg, use_flash=use_flash)
    rng = np.random.default_rng(0)
    video = rng.random((2, 8, 32, 32, 3)).astype(np.float32)
    params = model.init({"params": jax.random.PRNGKey(0)}, jnp.asarray(video))
    want = np.asarray(model.apply(params, jnp.asarray(video)))

    port = ViViTFeatureExtractor(port_config.ViViTConfig(**VIVIT_KW), device=CPU)
    port.load_state_dict(vivit_from_flax(_np_tree(params)))
    with torch.inference_mode():
        got = port(torch.from_numpy(video)).numpy()
    assert got.shape == (2, 64) and got.dtype == np.float32
    np.testing.assert_allclose(got, want, atol=1e-4, rtol=1e-4)


def test_vivit_token_order_is_pinned():
    """A tubelet permute that differs from (t', h', w') x (t, ph, pw, C)
    still gives plausible features; only a value check pins it."""
    cfg = port_config.ViViTConfig(**VIVIT_KW)
    jparams = JaxViViT(jax_config.ViViTConfig(**VIVIT_KW), use_flash=False).init(
        {"params": jax.random.PRNGKey(1)}, jnp.zeros((1, 8, 32, 32, 3)))
    from mmer_tpu.models.vivit import TubeletEmbed as JaxTubelet
    rng = np.random.default_rng(1)
    video = rng.random((1, 8, 32, 32, 3)).astype(np.float32)
    want = JaxTubelet(jax_config.ViViTConfig(**VIVIT_KW)).apply(
        {"params": jparams["params"]["embed"]}, jnp.asarray(video))
    port = ViViTFeatureExtractor(cfg, device=CPU)
    port.load_state_dict(vivit_from_flax(_np_tree(jparams)))
    with torch.inference_mode():
        got = port.embed(torch.from_numpy(video)).numpy()
    np.testing.assert_allclose(got, np.asarray(want), atol=1e-5, rtol=1e-5)


def test_vivit_bf16_rounding_points():
    """bf16 residual stream from the tubelet GEMM on, f32 FFN biases, bf16
    p before P.V.  The port's plain path takes the JAX module's route with
    the same rounding points (XLA attention, the Pallas FFN in interpret
    mode) and must agree with it to the bit but for rare flips; rounding
    the FFN biases to bf16 instead reads 2.4e-3 here.  (The JAX Pallas
    attention rounds p elsewhere: the port is 3.6e-3 from that route, which
    is the JAX package's own gap between its two routes.)"""
    rng = np.random.default_rng(0)
    video = rng.random((2, 8, 32, 32, 3)).astype(np.float32)
    jcfg = jax_config.ViViTConfig(**_bf16(VIVIT_KW))
    params = _perturbed(JaxViViT(jcfg, use_flash=False).init(
        {"params": jax.random.PRNGKey(0)}, jnp.asarray(video)), 1)
    want = JaxViViT(jcfg, use_flash=False, fused_blocks=True).apply(
        params, jnp.asarray(video))

    port = ViViTFeatureExtractor(port_config.ViViTConfig(**_bf16(VIVIT_KW)),
                                 device=CPU)
    port.load_state_dict(vivit_from_flax(params))
    with torch.inference_mode():
        got = port(torch.from_numpy(video)).numpy()
    assert _rel_l2(got, want) <= 1e-4, _rel_l2(got, want)


# -- Wav2Vec2 ----------------------------------------------------------------

@pytest.fixture(scope="module")
def jax_w2v2():
    cfg = jax_config.Wav2Vec2Config(**W2V2_KW)
    model = JaxWav2Vec2(cfg)
    params = model.init({"params": jax.random.PRNGKey(3)},
                        jnp.zeros((1, 1600), jnp.float32))
    return cfg, model, params


def test_wav2vec2_encoder_matches_jax(jax_w2v2):
    """Padded frames: zeroed before the positional conv, masked with the
    finite −1e9 key bias."""
    cfg, model, params = jax_w2v2
    rng = np.random.default_rng(0)
    wave = rng.normal(size=(2, 4000)).astype(np.float32)
    t = feat_extract_output_length(cfg, 4000)
    lens = np.array([t, feat_extract_output_length(cfg, 2500)])
    mask = np.arange(t)[None, :] >= lens[:, None]
    want = np.asarray(model.apply(params, jnp.asarray(wave), jnp.asarray(mask)))

    port = Wav2Vec2Encoder(port_config.Wav2Vec2Config(**W2V2_KW), device=CPU)
    port.load_state_dict(wav2vec2_from_flax(_np_tree(params)))
    with torch.inference_mode():
        got = port(torch.from_numpy(wave), torch.from_numpy(mask)).numpy()
    assert got.shape == want.shape == (2, t, 32)
    np.testing.assert_allclose(got, want, atol=1e-4, rtol=1e-4)


@pytest.mark.parametrize("mega", [True, False])
def test_wav2vec2_encoder_flash_matches_jax_pallas(jax_w2v2, mega):
    """``use_flash_attn=True`` (q, k, v through ``flash_attention`` with one
    key length per clip) with a pad mask, on either conv route, against the
    JAX encoder with ``use_pallas=True`` (conv pyramid, fused FFN and varlen
    flash attention; off a TPU each of its kernels runs in Pallas interpret
    mode by default) on the same params.  f32: the tolerance of
    tests/test_wav2vec2.py's Pallas-vs-XLA case.  Padded frames' rows are
    compared too: every row has at least one valid key."""
    cfg, _, params = jax_w2v2
    rng = np.random.default_rng(4)
    wave = rng.normal(size=(2, 3200)).astype(np.float32)
    t = feat_extract_output_length(cfg, 3200)
    mask = np.zeros((2, t), bool)
    mask[1, t // 2:] = True
    want = np.asarray(JaxWav2Vec2(cfg, use_pallas=True).apply(
        params, jnp.asarray(wave), jnp.asarray(mask)))

    port = Wav2Vec2Encoder(port_config.Wav2Vec2Config(**W2V2_KW), device=CPU,
                           use_flash_attn=True, mega=mega)
    assert all(layer.use_flash_attn for layer in port.layers)
    assert port.feature_encoder.mega is mega
    port.load_state_dict(wav2vec2_from_flax(_np_tree(params)))
    with torch.inference_mode():
        got = port(torch.from_numpy(wave), torch.from_numpy(mask)).numpy()
    np.testing.assert_allclose(got, want, atol=5e-4, rtol=5e-4)


def test_wav2vec2_flash_flag_follows_kernels_and_embedder_keeps_it_off():
    """``use_flash_attn=None`` follows ``use_kernels`` (the JAX encoder's
    follows ``use_pallas``); ``AudioEmbedder`` keeps it off and the
    whole-pyramid conv route by default, as the JAX ``AudioEmbedder`` does,
    and builds the all-kernel encoder only when asked by keyword."""
    cfg = port_config.Wav2Vec2Config(**W2V2_KW)
    for use_kernels, flag, want in [(True, None, True), (False, None, False),
                                    (True, False, False), (False, True, True)]:
        enc = Wav2Vec2Encoder(cfg, device=CPU, use_kernels=use_kernels,
                              use_flash_attn=flag)
        assert [layer.use_flash_attn for layer in enc.layers] == [want] * 2
    emb = AudioEmbedder(cfg, device=CPU)
    assert not any(layer.use_flash_attn for layer in emb.model.layers)
    assert emb.model.feature_encoder.mega is True
    emb = AudioEmbedder(cfg, device=CPU, use_flash_attn=True, mega=False)
    assert all(layer.use_flash_attn for layer in emb.model.layers)
    assert emb.model.feature_encoder.mega is False
    assert JaxAudioEmbedder(jax_config.Wav2Vec2Config(**W2V2_KW),
                            use_pallas=False).model.use_flash_attn is False


@pytest.mark.parametrize("flash", [True, False])
def test_wav2vec2_layer_attention_routes_bf16_rounding_points(jax_w2v2, flash):
    """The bf16 layer on each attention route, named explicitly (the
    encoder's default follows ``use_kernels``).  With ``use_flash_attn`` q,
    k, v stay in bf16 and the attention output is rounded to bf16 before the
    ``out`` projection; the plain route keeps f32 until that projection
    rounds.  Both round at the points of the JAX layer on its XLA attention
    and Pallas FFN (interpret); f32 summation order alone gives ~1.5e-6."""
    _, _, params = jax_w2v2
    params = _perturbed(params, 2)
    rng = np.random.default_rng(4)
    x = rng.normal(size=(2, 20, 32)).astype(np.float32)
    mask = np.zeros((2, 20), bool)
    mask[1, 14:] = True
    want = JaxEncoderLayer(jax_config.Wav2Vec2Config(**_bf16(W2V2_KW)),
                           use_fused_ffn=True).apply(
        {"params": params["params"]["layer_0"]}, jnp.asarray(x),
        jnp.asarray(mask))
    port = Wav2Vec2Encoder(port_config.Wav2Vec2Config(**_bf16(W2V2_KW)),
                           device=CPU, use_flash_attn=flash)
    port.load_state_dict(wav2vec2_from_flax(params))
    with torch.inference_mode():
        got = port.layers[0](torch.from_numpy(x), torch.from_numpy(mask))
    assert _rel_l2(got.numpy(), want) <= 2e-5, _rel_l2(got.numpy(), want)


def test_audio_embedder_matches_jax(jax_w2v2):
    """Uneven lengths in one batch (batch bucket 4 for 3 pieces + a split),
    and a clip longer than chunk_duration_s (0.5 s here) split and
    re-pooled."""
    cfg, _, params = jax_w2v2
    rng = np.random.default_rng(1)
    waves = [rng.normal(size=(n,)).astype(np.float32) * s
             for n, s in ((4800, 1.0), (12800, 0.3), (900, 2.0))]
    want = JaxAudioEmbedder(cfg, params=params, use_pallas=False).embed_batch(waves)
    port = AudioEmbedder(port_config.Wav2Vec2Config(**W2V2_KW), device=CPU,
                         params=wav2vec2_from_flax(_np_tree(params)))
    got = port.embed_batch(waves)
    assert got.shape == (3, 32)
    np.testing.assert_allclose(np.linalg.norm(got, axis=1), 1.0, atol=1e-5)
    np.testing.assert_allclose(got, want, atol=2e-5, rtol=1e-4)


def test_wav2vec2_layer_bf16_rounding_points(jax_w2v2):
    """f32 residual stream; bf16 GEMM operands, FFN biases and attention
    probabilities; one padded key row.  Against the JAX layer on its Pallas
    FFN route (interpret mode), which has the same rounding points: f32
    summation order alone gives ~1.5e-6."""
    _, _, params = jax_w2v2
    params = _perturbed(params, 2)
    rng = np.random.default_rng(4)
    x = rng.normal(size=(2, 20, 32)).astype(np.float32)
    mask = np.zeros((2, 20), bool)
    mask[1, 14:] = True
    want = JaxEncoderLayer(jax_config.Wav2Vec2Config(**_bf16(W2V2_KW)),
                           use_fused_ffn=True).apply(
        {"params": params["params"]["layer_0"]}, jnp.asarray(x),
        jnp.asarray(mask))
    port = Wav2Vec2Encoder(port_config.Wav2Vec2Config(**_bf16(W2V2_KW)),
                           device=CPU)
    port.load_state_dict(wav2vec2_from_flax(params))
    with torch.inference_mode():
        got = port.layers[0](torch.from_numpy(x), torch.from_numpy(mask))
    assert got.dtype == torch.float32
    assert _rel_l2(got.numpy(), want) <= 2e-5, _rel_l2(got.numpy(), want)


def test_audio_embedder_bf16_matches_jax(jax_w2v2):
    """The whole bf16 embedder against the JAX one on its Pallas route
    (conv encoder and FFN kernels in interpret mode): 1.8e-3 apart, against
    3.2e-3 between JAX's bf16 and f32 embeddings.  JAX's own bf16 routes are
    as far from one another (Pallas against XLA 1.4e-3, XLA jitted against
    op by op 2.1e-3): the distance is bf16 rounding order spread over the
    layers.  The positional conv's GELU is not what sets it: the port rounds
    it once, JAX's ``0.5 x erfc(-x bf16(sqrt 1/2))`` rounds each op (op by
    op) or all but the erfc argument (jitted), which moves a third of that
    module's outputs by one rounding, yet taking either sequence in the port
    moves this distance only to 1.75e-3 / 1.79e-3 (ROADMAP C4)."""
    _, _, params = jax_w2v2
    params = _perturbed(params, 2)
    rng = np.random.default_rng(1)
    waves = [rng.normal(size=(n,)).astype(np.float32) * s
             for n, s in ((4800, 1.0), (12800, 0.3), (900, 2.0))]
    want = JaxAudioEmbedder(jax_config.Wav2Vec2Config(**_bf16(W2V2_KW)),
                            params=params, use_pallas=True).embed_batch(waves)
    port = AudioEmbedder(port_config.Wav2Vec2Config(**_bf16(W2V2_KW)),
                         device=CPU, params=wav2vec2_from_flax(params))
    got = port.embed_batch(waves)
    np.testing.assert_allclose(np.linalg.norm(got, axis=1), 1.0, atol=1e-5)
    assert _rel_l2(got, want) <= 2.5e-3, _rel_l2(got, want)


# -- fusion ------------------------------------------------------------------

def test_fusion_matches_jax():
    """Padded video tokens (the audio token is never masked), and the real
    last-layer attention probabilities from return_attn."""
    jcfg = jax_config.ModelConfig(**FUSION_KW)
    model = JaxFusion(jcfg)
    rng = np.random.default_rng(2)
    video = rng.normal(size=(3, 3, 64)).astype(np.float32)
    audio = rng.normal(size=(3, 32)).astype(np.float32)
    mask = np.array([[0, 0, 0], [0, 1, 1], [0, 0, 1]], bool)
    params = model.init(jax.random.PRNGKey(0), video, audio, mask)
    # Non-trivial LayerNorm params and pos_embed, so a layout slip shows.
    params = jax.tree_util.tree_map(
        lambda a: a + 0.1 * rng.normal(size=a.shape).astype(np.float32),
        _np_tree(params))
    w_probs, w_logits, w_attn = model.apply(params, video, audio, mask,
                                            return_attn=True)

    port = MultimodalEmotionModel(port_config.ModelConfig(**FUSION_KW),
                                  device=CPU)
    port.load_state_dict(fusion_from_flax(params))
    with torch.inference_mode():
        probs, logits, attn = port(torch.from_numpy(video),
                                   torch.from_numpy(audio),
                                   torch.from_numpy(mask), return_attn=True)
    np.testing.assert_allclose(logits.numpy(), np.asarray(w_logits),
                               atol=1e-4, rtol=1e-4)
    np.testing.assert_allclose(probs.numpy(), np.asarray(w_probs), atol=1e-5)
    np.testing.assert_allclose(attn.numpy(), np.asarray(w_attn), atol=1e-5)
    assert attn.shape == (3, 2, 4, 4)
    # Padded keys get (numerically) zero probability.
    assert float(attn[1, :, :, 1:3].max()) < 1e-6


def test_fusion_bf16_matches_jax():
    """bf16 GEMM operands, each Dense's product rounded before its bias is
    added, f32 LayerNorms and softmax: the same rounding points as the JAX
    module, so only summation order remains (logits ~1e-7 apart, against
    2.3e-2 between JAX's bf16 and f32 logits)."""
    jcfg = jax_config.ModelConfig(**_bf16(FUSION_KW))
    rng = np.random.default_rng(2)
    video = rng.normal(size=(3, 3, 64)).astype(np.float32)
    audio = rng.normal(size=(3, 32)).astype(np.float32)
    mask = np.array([[0, 0, 0], [0, 1, 1], [0, 0, 1]], bool)
    params = _perturbed(JaxFusion(jcfg).init(jax.random.PRNGKey(0), video,
                                             audio, mask), 3)
    w_probs, w_logits = JaxFusion(jcfg).apply(params, video, audio, mask)[:2]

    port = MultimodalEmotionModel(port_config.ModelConfig(**_bf16(FUSION_KW)),
                                  device=CPU)
    port.load_state_dict(fusion_from_flax(params))
    with torch.inference_mode():
        probs, logits, _ = port(torch.from_numpy(video),
                                torch.from_numpy(audio),
                                torch.from_numpy(mask))
    assert _rel_l2(logits.numpy(), w_logits) <= 1e-5
    np.testing.assert_allclose(probs.numpy(), np.asarray(w_probs), atol=1e-6)


def test_fusion_batchnorm_variant_not_ported():
    """The v1 batchnorm variant once raised here; it is ported now (held to
    flax in tests/test_torch_train.py), and only an unknown kind raises."""
    norm = TokenNorm("batchnorm", 8, device=CPU)
    assert set(dict(norm.named_buffers())) == {"bn.running_mean",
                                               "bn.running_var"}
    with pytest.raises(ValueError):
        TokenNorm("groupnorm", 8, device=CPU)


# -- the JAX package's seeded weights ----------------------------------------

@pytest.mark.parametrize("model", ["vivit", "wav2vec2", "fusion"])
def test_seeded_init_follows_flax_families(model):
    """The port's default weights are the JAX package's own seeded init:
    ViViT and Wav2Vec2 for ``cfg.param_seed``, the fusion model as the JAX
    trainer seeds it (``split(PRNGKey(seed))[1]``), every value within 4
    float32 ulp of flax's (tests/test_torch_jax_weights.py holds the draws
    one by one)."""
    if model == "vivit":
        cfg = jax_config.ViViTConfig(**VIVIT_KW)
        jp = JaxViViT(cfg, use_flash=False).init(
            {"params": jax.random.PRNGKey(cfg.param_seed)},
            jnp.zeros((1, 8, 32, 32, 3)))
        ref = vivit_from_flax(_np_tree(jp))
        port = init_vivit(port_config.ViViTConfig(**VIVIT_KW), device=CPU)
    elif model == "wav2vec2":
        cfg = jax_config.Wav2Vec2Config(**W2V2_KW)
        jp = JaxWav2Vec2(cfg).init({"params": jax.random.PRNGKey(cfg.param_seed)},
                                   jnp.zeros((1, 1600)))
        ref = wav2vec2_from_flax(_np_tree(jp))
        port = init_wav2vec2(port_config.Wav2Vec2Config(**W2V2_KW), device=CPU)
    else:
        cfg = jax_config.ModelConfig(**FUSION_KW)
        _, key = jax.random.split(jax.random.PRNGKey(0))
        jp = JaxFusion(cfg).init(key, jnp.zeros((1, 3, 64)),
                                 jnp.zeros((1, 32)), jnp.zeros((1, 3), bool))
        ref = fusion_from_flax(_np_tree(jp))
        port = init_fusion(port_config.ModelConfig(**FUSION_KW), device=CPU,
                           seed=0)
    ours = {k: v.detach().numpy() for k, v in port.state_dict().items()}
    assert set(ours) == set(ref)
    for k, v in ref.items():
        v = v.numpy()
        assert ours[k].shape == v.shape, k
        ulps = np.abs(ours[k].view(np.int32).astype(np.int64)
                      - v.view(np.int32).astype(np.int64))
        assert np.all(np.sign(ours[k]) == np.sign(v)) and ulps.max() <= 4, k
