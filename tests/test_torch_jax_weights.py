"""The JAX package's seeded weights redrawn without JAX
(``mmer_tpu_torch/models/jax_init.py``), the extractors' flax ``.msgpack``
params files, and the HF Wav2Vec2 converter, against jax 0.9 / flax 0.12 on
the CPU.

Values are compared in float32 ulp (the distance between the int32 views of
two floats of one sign).  The bound is 4 ulp with at least 90 % of the values
bit-equal; on this CPU every leaf checked reads bit-equal.

The file also writes the committed fixture that ``chip_smoke.py`` holds the
card to (the JAX package's sampled leaves and features):

    JAX_PLATFORMS=cpu python tests/test_torch_jax_weights.py --write
"""

from __future__ import annotations

import dataclasses
import hashlib
import json
import os
import subprocess
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if __name__ == "__main__":          # run as the fixture writer
    sys.path.insert(0, REPO)

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import flax
import flax.linen as nn
from flax.core import scope as flax_scope
import mmer_tpu.config as jax_config
import mmer_tpu.train.checkpoint as jax_ckpt
from mmer_tpu.models.fusion import MultimodalEmotionModel as JaxFusion
from mmer_tpu.models.vivit import ViViTFeatureExtractor as JaxViViT
from mmer_tpu.models.vivit import init_vivit_params
from mmer_tpu.models.wav2vec2 import AudioEmbedder as JaxAudioEmbedder
from mmer_tpu.models.wav2vec2 import Wav2Vec2Encoder as JaxWav2Vec2
import mmer_tpu_torch.config as port_config
from mmer_tpu_torch.models import jax_init
from mmer_tpu_torch.models.convert import (vivit_from_flax, vivit_to_flax,
                                           wav2vec2_from_flax, wav2vec2_to_flax)
from mmer_tpu_torch.models.layers import write_params
from mmer_tpu_torch.models.wav2vec2 import AudioEmbedder, Wav2Vec2Encoder
from mmer_tpu_torch.preprocess.extract import VideoFeatureExtractor

from torch_threads import few_threads  # noqa: F401

CPU = torch.device("cpu")
MAX_ULP = 4
MIN_EQUAL = 0.90
SEEDS = (0, 1, 42, 2 ** 31 + 5)
N_DRAWS = 1_000_000
FULL_SAMPLES = 4096

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


def _np_tree(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _ulps(a, b) -> np.ndarray:
    """float32 ulp distance; values of opposite signs count as far apart."""
    a = np.asarray(a, np.float32).ravel()
    b = np.asarray(b, np.float32).ravel()
    ia = a.view(np.int32).astype(np.int64)
    ib = b.view(np.int32).astype(np.int64)
    ia = np.where(ia < 0, -(ia & 0x7FFFFFFF), ia)
    ib = np.where(ib < 0, -(ib & 0x7FFFFFFF), ib)
    return np.abs(ia - ib)


def _assert_close(got, want, what: str) -> float:
    """Within MAX_ULP everywhere and bit-equal on MIN_EQUAL of the values;
    returns the bit-equal share."""
    d = _ulps(got, want)
    worst = int(d.argmax()) if d.size else 0
    assert d.size == 0 or d.max() <= MAX_ULP, (
        f"{what}: {int(d.max())} ulp at flat index {worst} "
        f"({np.ravel(got)[worst]!r} vs {np.ravel(want)[worst]!r})")
    share = float((d == 0).mean()) if d.size else 1.0
    assert share >= MIN_EQUAL, f"{what}: only {share:.4f} bit-equal"
    return share


def _assert_trees_close(got: dict, want: dict, what: str) -> None:
    fg, fw = jax_init.flat_leaves(got), jax_init.flat_leaves(_np_tree(want))
    assert list(fg) == list(fw), f"{what}: tree structures differ"
    for k in fw:
        assert tuple(fg[k].shape) == fw[k].shape, (what, k)
        _assert_close(fg[k].numpy(), fw[k], f"{what}/{k}")


# -- threefry, keys and draws -----------------------------------------------------

@pytest.mark.parametrize("seed", SEEDS)
def test_keys_and_bits_bit_equal(seed):
    """PRNGKey, split, fold_in and 32-bit random_bits equal jax's with
    jax_threefry_partitionable on."""
    assert jax.config.jax_threefry_partitionable
    key = jax.random.PRNGKey(seed)
    ours = jax_init.PRNGKey(seed)
    assert tuple(np.asarray(key).tolist()) == ours
    assert ([tuple(k) for k in np.asarray(jax.random.split(key, 5)).tolist()]
            == jax_init.split(ours, 5))
    for data in (0, 1, 12345, 2 ** 32 - 1):
        assert (tuple(np.asarray(jax.random.fold_in(key, data)).tolist())
                == jax_init.fold_in(ours, data))
    want = np.asarray(jax.random.bits(key, (3, 70_001)), np.uint32)
    idx = torch.arange(want.size, dtype=torch.int64)
    got = jax_init.random_bits(ours, idx).numpy().astype(np.uint32)
    np.testing.assert_array_equal(got, want.ravel())
    # An element's bits depend on its key and flat index only.
    some = torch.tensor([0, 17, 70_000, 150_002])
    np.testing.assert_array_equal(
        jax_init.random_bits(ours, some).numpy().astype(np.uint32),
        want.ravel()[some.numpy()])


def test_uniforms_bit_equal():
    key = jax.random.PRNGKey(42)
    want = np.asarray(jax.random.uniform(key, (N_DRAWS,), jnp.float32))
    bits = jax_init.random_bits(jax_init.PRNGKey(42), torch.arange(N_DRAWS))
    np.testing.assert_array_equal(jax_init._unit_uniform(bits).numpy(), want)


@pytest.mark.parametrize("family", ["normal", "truncated_normal", "lecun_normal"])
def test_normal_families_within_ulps(family):
    """jax.random.normal, truncated_normal(-2, 2) and flax's lecun_normal on
    a (1024, 977) kernel, each drawn jitted as flax's init draws them."""
    key = jax.random.PRNGKey(7)
    ours = jax_init.PRNGKey(7)
    idx = torch.arange(N_DRAWS)
    if family == "normal":
        want = jax.jit(lambda k: jax.random.normal(k, (N_DRAWS,)))(key)
        got = jax_init.normal(ours, idx)
    elif family == "truncated_normal":
        want = jax.jit(lambda k: jax.random.truncated_normal(
            k, -2.0, 2.0, (N_DRAWS,)))(key)
        got = jax_init.truncated_normal(ours, idx)
    else:
        shape = (1024, 977)
        want = jax.jit(lambda k: nn.initializers.lecun_normal()(k, shape))(key)
        leaf = jax_init.Leaf("lecun_normal", shape, 1, 1024.0)
        got = jax_init.draw_leaf(leaf, ours, torch.arange(1024 * 977))
    _assert_close(got.numpy(), np.asarray(want), family)


def test_truncated_normal_bounds_bit_equal():
    """The bounds erf(-+2/sqrt(2)) as XLA's float32 erf gives them."""
    sqrt2 = np.float32(np.sqrt(2.0))
    for lo_hi, bits in ((-2.0, jax_init.TRUNC_LOWER_BITS),
                        (2.0, jax_init.TRUNC_UPPER_BITS)):
        b = jax.jit(lambda v: jax.lax.erf(v / sqrt2))(jnp.float32(lo_hi))
        assert int(np.asarray(b, np.float32).view(np.uint32)) == bits


@pytest.mark.parametrize("separator", [False, True])
def test_fold_in_static_matches_flax(separator):
    """Module paths and per-scope counters as flax's params see them."""
    assert flax.config.flax_fix_rng_separator == jax_init.FIX_RNG_SEPARATOR
    key = jax.random.PRNGKey(3)
    paths = [(1,), (2,), ("embed", "proj", 1), ("block_11", "to_qkv", 1),
             ("feature_encoder", "conv_6", 2), ("pos_conv", "conv", 1),
             ("layer_23", "q", 1), ("fusion", "layer_1", "self_attn", "out", 1),
             ("classifier", "norm_0", "BatchNorm_0", 2), ("fusion", 1),
             ("über", 300)]
    with flax.config.temp_flip_flag("fix_rng_separator", separator):
        for path in paths:
            want = np.asarray(flax_scope._fold_in_static(key, path))
            got = jax_init.fold_in_static(jax_init.PRNGKey(3), path,
                                          separator=separator)
            assert tuple(want.tolist()) == got, path


# -- whole trees --------------------------------------------------------------------

def test_tiny_vivit_tree_matches_flax():
    cfg = jax_config.ViViTConfig(**VIVIT_KW)
    _, want = init_vivit_params(cfg, use_flash=False)
    got = jax_init.vivit_tree(port_config.ViViTConfig(**VIVIT_KW))
    _assert_trees_close(got, want, "vivit")


@pytest.mark.parametrize("pool", ["cls", "mean"])
def test_tiny_vivit_tree_pooling(pool):
    """Without a CLS token the positional embedding is the root's first
    param (counter 1)."""
    kw = dict(VIVIT_KW, pool=pool, param_seed=5)
    cfg = jax_config.ViViTConfig(**kw)
    want = JaxViViT(cfg, use_flash=False).init(
        {"params": jax.random.PRNGKey(5)}, jnp.zeros((1, 8, 32, 32, 3)))
    got = jax_init.vivit_tree(port_config.ViViTConfig(**kw))
    _assert_trees_close(got, want, f"vivit {pool}")


def test_tiny_wav2vec2_tree_matches_flax():
    """Conv encoder, DenseGeneral heads and the grouped positional conv's
    (k, C/g, C) kernel with fan-in k*C/g."""
    cfg = jax_config.Wav2Vec2Config(**W2V2_KW)
    want = jax.jit(lambda k: JaxWav2Vec2(cfg).init(
        {"params": k}, jnp.zeros((1, cfg.sample_rate))))(
            jax.random.PRNGKey(cfg.param_seed))
    got = jax_init.wav2vec2_tree(port_config.Wav2Vec2Config(**W2V2_KW))
    _assert_trees_close(got, want, "wav2vec2")
    assert got["params"]["pos_conv"]["conv"]["kernel"].shape == (16, 8, 32)


@pytest.mark.parametrize("norm", ["layernorm", "batchnorm"])
@pytest.mark.parametrize("seed", [0, 11])
@pytest.mark.parametrize("batched", [False, True])
def test_tiny_fusion_tree_matches_trainer(norm, seed, batched):
    """The JAX trainer's init: split(PRNGKey(seed)), the second key, then
    model.init on two samples, eagerly (``train_model``) or under
    ``jit(vmap(...))`` over the seeds of a call (``train_many_seeds``, whose
    jitted init folds ``pos_embed``'s two scale constants); batch_stats
    included."""
    cfg = jax_config.ModelConfig(**FUSION_KW, norm=norm)
    sample = (jnp.zeros((2, 3, 64)), jnp.zeros((2, 32)), jnp.zeros((2, 3), bool))

    def init(seed_key):
        _, init_key = jax.random.split(seed_key)
        return dict(JaxFusion(cfg).init({"params": init_key}, *sample))

    if batched:
        keys = jnp.stack([jax.random.PRNGKey(seed), jax.random.PRNGKey(seed + 1)])
        want = jax.tree_util.tree_map(lambda a: a[0],
                                      jax.jit(jax.vmap(init))(keys))
    else:
        want = init(jax.random.PRNGKey(seed))
    got = jax_init.fusion_tree(port_config.ModelConfig(**FUSION_KW, norm=norm),
                               seed, ((2, 3, 64), (2, 32)), jitted=batched)
    assert set(got) == set(want) == ({"params", "batch_stats"}
                                     if norm == "batchnorm" else {"params"})
    _assert_trees_close(got, want, f"fusion {norm} {seed} batched={batched}")


def test_engine_seeded_head_is_the_jax_engines():
    """Without fusion params the engine serves the JAX engine's seeded head:
    ``model.init`` under ``PRNGKey(0)`` itself (``serve/engine.py``)."""
    from mmer_tpu_torch.models.convert import fusion_from_flax
    from mmer_tpu_torch.serve.engine import InferenceEngine

    cfg = jax_config.ModelConfig(**FUSION_KW)
    t = cfg.max_seq_len - 1
    want = fusion_from_flax(_np_tree(jax.jit(lambda k: JaxFusion(cfg).init(
        {"params": k}, jnp.zeros((1, t, cfg.video_dim)),
        jnp.zeros((1, cfg.audio_dim)), jnp.zeros((1, t), bool)))(
            jax.random.PRNGKey(0))))
    got = InferenceEngine(CPU, model_cfg=port_config.ModelConfig(
        **FUSION_KW)).fusion.state_dict()
    assert set(got) == set(want)
    for k in want:
        _assert_close(got[k].numpy(), want[k].numpy(), k)


def _sampled(tree: dict, k: int) -> dict:
    return {name: np.ravel(v)[jax_init.sample_indices(v.size, k)]
            for name, v in jax_init.flat_leaves(_np_tree(tree)).items()}


def _check_samples(spec: dict, root, want: dict, k: int, what: str) -> None:
    got = jax_init.flat_leaves(jax_init.draw_tree(
        spec, root, indices=lambda n: jax_init.sample_indices(n, k)))
    assert list(got) == list(want), f"{what}: leaves differ"
    for name in want:
        _assert_close(got[name].numpy(), want[name], f"{what}/{name}")


@pytest.mark.parametrize("model", ["vivit", "wav2vec2"])
def test_full_default_tree_sampled(model):
    """The full default extractors (ViViT-B, Wav2Vec2-large) at 4,096 sampled
    indices a leaf against ``init_vivit_params`` and
    ``AudioEmbedder._seeded_params``."""
    if model == "vivit":
        cfg = jax_config.ViViTConfig()
        _, tree = init_vivit_params(cfg, use_flash=False)
        spec = jax_init.vivit_spec(port_config.ViViTConfig())
    else:
        cfg = jax_config.Wav2Vec2Config()
        tree = JaxAudioEmbedder(cfg, use_pallas=False).params
        spec = jax_init.wav2vec2_spec(port_config.Wav2Vec2Config())
    want = _sampled(tree["params"], FULL_SAMPLES)
    del tree
    _check_samples(spec, jax_init.PRNGKey(cfg.param_seed), want, FULL_SAMPLES,
                   model)


def test_fixture_matches_regenerator():
    """The committed fixture: written by this JAX and flax version from the
    seeded inputs that chip_smoke.py rebuilds, and its sampled leaves equal
    to what the regenerator draws at those indices."""
    with np.load(jax_init.FIXTURE) as z:
        fx = {k: z[k] for k in z.files}
    meta = json.loads(str(fx["meta"]))
    assert meta["jax"] == jax.__version__ and meta["flax"] == flax.__version__
    chunks, waves = jax_init.reference_inputs(meta["input_seed"])
    assert jax_init.inputs_digest(chunks, waves) == str(fx["inputs_sha1"])
    assert fx["video_float32"].shape == fx["video_bfloat16"].shape == (2, 768)
    assert (fx["audio_float32"].shape == fx["audio_bfloat16"].shape
            == fx["audio_bfloat16_xla"].shape == (3, 1024))
    for name, spec, cfg in (
            ("vivit", jax_init.vivit_spec(port_config.ViViTConfig()),
             port_config.ViViTConfig()),
            ("wav2vec2", jax_init.wav2vec2_spec(port_config.Wav2Vec2Config()),
             port_config.Wav2Vec2Config())):
        assert meta[f"{name}_seed"] == cfg.param_seed
        got = jax_init.flat_leaves(jax_init.draw_tree(
            spec, jax_init.PRNGKey(cfg.param_seed),
            indices=lambda n: jax_init.sample_indices(n, meta["samples"])))
        assert list(got) == list(fx[f"{name}_leaves"])
        flat = np.concatenate([v.numpy() for v in got.values()])
        _assert_close(flat, fx[f"{name}_samples"], f"fixture {name}")


# -- the extractors' params files ---------------------------------------------------

def _perturbed(tree, seed):
    rng = np.random.default_rng(seed)
    return jax.tree_util.tree_map(
        lambda a: (a + 0.1 * rng.normal(size=a.shape)).astype(np.float32),
        _np_tree(tree))


def _extractor(model, **kw):
    if model == "vivit":
        return VideoFeatureExtractor(port_config.ViViTConfig(**VIVIT_KW),
                                     device=CPU, **kw)
    return AudioEmbedder(port_config.Wav2Vec2Config(**W2V2_KW), device=CPU, **kw)


def _jax_tree(model):
    if model == "vivit":
        return init_vivit_params(jax_config.ViViTConfig(**VIVIT_KW),
                                 use_flash=False)[1]
    return JaxAudioEmbedder(jax_config.Wav2Vec2Config(**W2V2_KW),
                            use_pallas=False).params


@pytest.mark.parametrize("model", ["vivit", "wav2vec2"])
def test_jax_msgpack_loads_into_port(model, tmp_path):
    """A params file the JAX package writes (save_params_msgpack) loads into
    the port's extractor as convert.py maps it."""
    tree = _perturbed(_jax_tree(model), 3)
    path = str(tmp_path / "params.msgpack")
    jax_ckpt.save_params_msgpack(path, tree)
    ext = _extractor(model, params_path=path)
    want = (vivit_from_flax if model == "vivit" else wav2vec2_from_flax)(tree)
    got = ext.model.state_dict()
    assert set(got) == set(want)
    for k in want:
        assert torch.equal(got[k], want[k]), k


@pytest.mark.parametrize("model", ["vivit", "wav2vec2"])
def test_port_msgpack_loads_into_jax(model, tmp_path):
    """A params file the port writes reads back through the JAX package's
    load_params_msgpack(path, target) to an equal tree: the seeded weights an
    extractor writes on first use (JAX's own init), and any state dict."""
    target = _jax_tree(model)
    path = str(tmp_path / "seeded.msgpack")
    _extractor(model, params_path=path)
    seeded = jax.tree_util.tree_map(
        lambda a: torch.from_numpy(np.array(a)),
        _np_tree(jax_ckpt.load_params_msgpack(path, target)))
    _assert_trees_close(seeded, target, f"{model} seeded")
    tree = _perturbed(target, 4)
    sd = (vivit_from_flax if model == "vivit" else wav2vec2_from_flax)(tree)
    to_flax = (vivit_to_flax if model == "vivit"
               else lambda s: wav2vec2_to_flax(s, W2V2_KW["num_heads"]))
    path = str(tmp_path / "any.msgpack")
    write_params(path, sd, to_flax)
    back = _np_tree(jax_ckpt.load_params_msgpack(path, target))
    jax.tree_util.tree_map(np.testing.assert_array_equal, back, tree)
    # The bytes are flax's own for that tree.
    with open(path, "rb") as f:
        assert f.read() == flax.serialization.to_bytes(tree)


@pytest.mark.parametrize("model", ["vivit", "wav2vec2"])
def test_npz_params_round_trip(model, tmp_path):
    """``.npz`` stays: written with the seeded weights on first use, read
    back on the next."""
    path = str(tmp_path / "params.npz")
    first = _extractor(model, params_path=path).model.state_dict()
    with np.load(path) as z:
        assert set(z.files) == set(first)
    again = _extractor(model, params_path=path).model.state_dict()
    for k in first:
        assert torch.equal(first[k], again[k]), k


# -- the HF Wav2Vec2 converter --------------------------------------------------------

def _hf_twin():
    transformers = pytest.importorskip("transformers")
    hf_cfg = transformers.Wav2Vec2Config(
        hidden_size=32, num_hidden_layers=2, num_attention_heads=2,
        intermediate_size=64, conv_dim=(16, 16), conv_kernel=(10, 3),
        conv_stride=(5, 2), num_conv_pos_embeddings=16,
        num_conv_pos_embedding_groups=4, do_stable_layer_norm=True,
        feat_extract_norm="layer", conv_bias=True, layerdrop=0.0)
    torch.manual_seed(0)
    return transformers.Wav2Vec2Model(hf_cfg).eval()


@pytest.mark.parametrize("fmt", ["safetensors", "bin"])
def test_hf_converter_matches_jax_converter(fmt, tmp_path):
    """``python -m mmer_tpu_torch.models.port_wav2vec2`` on a saved random
    HF model equals the JAX converter's mapping exactly, and the port's f32
    encoder on it reproduces HF's last_hidden_state."""
    from mmer_tpu.models.wav2vec2 import convert_hf_state

    hf = _hf_twin()
    hf_dir = tmp_path / "hf"
    hf.save_pretrained(str(hf_dir), safe_serialization=fmt == "safetensors")
    assert (hf_dir / ("model.safetensors" if fmt == "safetensors"
                      else "pytorch_model.bin")).exists()
    out = str(tmp_path / "w2v2.msgpack")
    code = ("import sys\n"
            "from mmer_tpu_torch.models import port_wav2vec2\n"
            f"port_wav2vec2.main(['--hf', {str(hf_dir)!r}, '--out', {out!r}])\n"
            "bad = sorted(m for m in sys.modules\n"
            "             if m.split('.')[0] in ('transformers', 'jax', 'flax',\n"
            "                                   'mmer_tpu', 'safetensors'))\n"
            "sys.exit(1 if bad else 0)\n")
    # Both converters fold the positional conv's weight norm with
    # ``torch._weight_norm``, whose sums follow torch's thread count: the CLI
    # runs on this process's count, as the JAX converter below does.
    env = dict(os.environ, OMP_NUM_THREADS=str(torch.get_num_threads()))
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stdout + proc.stderr

    jcfg = jax_config.Wav2Vec2Config(**W2V2_KW)
    want = wav2vec2_from_flax(_np_tree(convert_hf_state(hf, jcfg)))
    cfg = port_config.Wav2Vec2Config(**W2V2_KW)
    emb = AudioEmbedder(cfg, device=CPU, use_kernels=False, params_path=out)
    got = emb.model.state_dict()
    assert set(got) == set(want)
    for k in want:
        assert torch.equal(got[k], want[k]), k

    enc = Wav2Vec2Encoder(cfg, device=CPU, use_kernels=False)
    enc.load_state_dict(got)
    wave = np.random.default_rng(0).normal(size=(2, 3200)).astype(np.float32)
    with torch.no_grad():
        ref = hf(torch.from_numpy(wave)).last_hidden_state.numpy()
        mine = enc(torch.from_numpy(wave)).numpy()
    rel = np.linalg.norm(mine - ref) / np.linalg.norm(ref)
    assert rel <= 1e-4, rel


def test_hf_converter_refuses_other_than_a_local_dir(tmp_path):
    from mmer_tpu_torch.models import port_wav2vec2

    with pytest.raises(SystemExit, match="local directory"):
        port_wav2vec2.main(["--hf", "audeering/wav2vec2-large-robust-12-ft-"
                            "emotion-msp-dim", "--out", str(tmp_path / "x.npz")])
    with pytest.raises(ValueError, match="do_stable_layer_norm"):
        port_wav2vec2.config_from_hf({"do_stable_layer_norm": False})


# -- the fixture writer ---------------------------------------------------------------

def write_fixture(path: str = jax_init.FIXTURE) -> None:
    """Write ``mmer_tpu_torch/assets/jax_reference.npz``: each full default
    extractor's leaves sampled at ``sample_indices(n, FIXTURE_SAMPLES)``, and
    the JAX package's features of ``reference_inputs()``: float32 on the XLA
    route, and bfloat16.  Wav2Vec2's bfloat16 features come from
    ``AudioEmbedder.embed_batch`` on the route the package takes on a TPU and
    the port's kernels mirror (``use_pallas=True``: the conv pyramid and FFN
    kernels, in interpret mode here), and from its XLA route
    (``audio_bfloat16_xla``): the two routes' roundings put them up to 0.64 %
    apart on the 0.5 s clip.  ViViT's bfloat16 features come from its XLA
    route only (its Pallas route at S = 1569 in interpret mode is too slow
    here); they set the bf16 floor of the video gate."""
    vcfg, wcfg = jax_config.ViViTConfig(), jax_config.Wav2Vec2Config()
    _, vparams = init_vivit_params(vcfg, use_flash=False)
    wparams = JaxAudioEmbedder(wcfg, use_pallas=False).params
    k = jax_init.FIXTURE_SAMPLES
    out = {}
    for name, tree in (("vivit", vparams), ("wav2vec2", wparams)):
        samples = _sampled(tree["params"], k)
        out[f"{name}_leaves"] = np.array(list(samples))
        out[f"{name}_samples"] = np.concatenate(list(samples.values()))
    chunks, waves = jax_init.reference_inputs(jax_init.FIXTURE_SEED)
    out["inputs_sha1"] = np.array(jax_init.inputs_digest(chunks, waves))
    frames = jnp.asarray(chunks).astype(jnp.float32) / 255.0
    for dt in ("float32", "bfloat16"):
        model = JaxViViT(dataclasses.replace(vcfg, compute_dtype=dt),
                         use_flash=False)
        out[f"video_{dt}"] = np.asarray(jax.jit(model.apply)(vparams, frames),
                                        np.float32)
        emb = JaxAudioEmbedder(dataclasses.replace(wcfg, compute_dtype=dt),
                               params=wparams, use_pallas=dt == "bfloat16")
        out[f"audio_{dt}"] = np.asarray(emb.embed_batch(waves), np.float32)
    emb = JaxAudioEmbedder(dataclasses.replace(wcfg, compute_dtype="bfloat16"),
                           params=wparams, use_pallas=False)
    out["audio_bfloat16_xla"] = np.asarray(emb.embed_batch(waves), np.float32)
    out["meta"] = np.array(json.dumps({
        "jax": jax.__version__, "flax": flax.__version__,
        "vivit_seed": vcfg.param_seed, "wav2vec2_seed": wcfg.param_seed,
        "samples": k, "input_seed": jax_init.FIXTURE_SEED,
        "chunks": list(chunks.shape), "waves": [len(w) for w in waves],
        "video_route": "XLA (use_flash=False)",
        "audio_route": "f32: XLA (use_pallas=False); bf16: Pallas "
                       "(use_pallas=True, interpret mode), XLA in audio_bfloat16_xla"}))
    os.makedirs(os.path.dirname(path), exist_ok=True)
    np.savez_compressed(path, **out)
    with open(path, "rb") as f:
        print(f"wrote {path}: {os.path.getsize(path)} bytes, sha1 "
              f"{hashlib.sha1(f.read()).hexdigest()}")


if __name__ == "__main__":
    if sys.argv[1:] != ["--write"]:
        sys.exit("usage: JAX_PLATFORMS=cpu python tests/test_torch_jax_weights.py --write")
    write_fixture()
