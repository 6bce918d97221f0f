"""What the port's CUDA kernels take, refused where a model is built.

The JAX kernels take any width; the CUDA kernels take the default ones (a
bf16 compute dtype, 512 conv channels, a first conv layer of at most 16 taps
on the whole-pyramid route, FFN and LN-matmul widths D in {768, 1024} with M a
multiple of 256 and N of 64, attention head dim 64 on the flash and the
plain route, positional-conv groups of 64 channels and at most 128 taps).
Each family has a pure function that names the first of these limits a
config breaks (``conv_pyramid.kernel_limits``, ``fused_blocks.ffn_limits``
and ``ln_matmul_limits``, ``flash_attention.attention_limits``,
``pos_conv.pos_conv_limits``, ``plain_attention.plain_attention_limits``, and
per model
``wav2vec2.kernel_limits`` and ``vivit.kernel_limits``), and the models call
them when they are built for a CUDA device with their kernels on, so that a
config the kernels do not take raises ``ValueError`` at construction, not in
the middle of a forward.  The functions are checked here directly, at the
default configs (no limit broken), at the tiny configs the parity tests use
(each limit named) and at a 400-tap first layer; and the refusal is checked
by building each model for ``cuda``, which raises before any tensor is made,
so it needs no card.
"""

import dataclasses

import pytest

from mmer_tpu_torch.config import ViViTConfig, Wav2Vec2Config
from mmer_tpu_torch.models import vivit, wav2vec2
from mmer_tpu_torch.models.vivit import ViViTFeatureExtractor
from mmer_tpu_torch.models.wav2vec2 import (AudioEmbedder, ConvFeatureEncoder,
                                            Wav2Vec2Encoder)
from mmer_tpu_torch.ops import conv_pyramid
from mmer_tpu_torch.ops.conv_pyramid import MAX_FIRST_TAPS, supports_config
from mmer_tpu_torch.ops.flash_attention import attention_limits
from mmer_tpu_torch.ops.fused_blocks import ffn_limits, ln_matmul_limits
from mmer_tpu_torch.ops.pos_conv import pos_conv_limits
from mmer_tpu_torch.preprocess.extract import VideoFeatureExtractor

from torch_threads import few_threads  # noqa: F401

# The tiny configs of tests/test_torch_models.py, in bf16.
VIVIT_TINY = dict(image_size=(32, 32), patch_size=(16, 16), num_frames=8,
                  tubelet_size=4, dim=64, depth=2, heads=2, dim_head=32,
                  mlp_dim=128)
W2V2_TINY = dict(hidden_dim=32, num_layers=2, num_heads=2, ffn_dim=64,
                 conv_dims=(16, 16), conv_strides=(5, 2), conv_kernels=(10, 3),
                 num_conv_pos_embeddings=16, num_conv_pos_embedding_groups=4)
# The default conv stack with a 400-tap first layer (the whole receptive
# field of the default stack in one layer).
FIRST_400 = dict(conv_kernels=(400, 3, 3, 3, 3, 2, 2))


def test_default_configs_break_no_limit():
    w, v = Wav2Vec2Config(), ViViTConfig()
    for mega in (True, False):
        assert conv_pyramid.kernel_limits(w, mega) is None
        for flash in (False, True):
            assert wav2vec2.kernel_limits(w, True, flash, mega) is None
    assert vivit.kernel_limits(v) is None
    assert ffn_limits(v.dim, v.mlp_dim) is None and ffn_limits(w.hidden_dim, w.ffn_dim) is None
    assert attention_limits(v.dim_head) is None
    assert attention_limits(w.hidden_dim // w.num_heads) is None
    assert ln_matmul_limits(768, 2304) is None and ln_matmul_limits(1024, 3072) is None
    assert pos_conv_limits(w) is None


@pytest.mark.parametrize("family,kw,words", [
    ("conv", dict(W2V2_TINY), "512 channels"),
    ("conv", dict(FIRST_400), f"at most {MAX_FIRST_TAPS}"),
    ("conv", dict(compute_dtype="float32"), "bf16 compute dtype"),
    ("conv", dict(feat_extract_norm="group"), "outside the ported family"),
    ("wav2vec2", dict(W2V2_TINY), "512 channels"),
    ("wav2vec2", dict(hidden_dim=512, num_heads=8), "D in (768, 1024)"),
    ("wav2vec2", dict(ffn_dim=4000), "M a multiple of 256"),
    ("wav2vec2", dict(num_conv_pos_embedding_groups=8), "groups of 64 channels"),
    ("wav2vec2", dict(num_conv_pos_embedding_groups=32), "groups of 64 channels"),
    ("wav2vec2", dict(num_conv_pos_embeddings=160), "at most 128 taps"),
    ("wav2vec2", dict(num_heads=8), "plain attention kernel takes head dim 64"),
    ("wav2vec2_flash", dict(num_heads=8), "head dim 64"),
    ("vivit", dict(VIVIT_TINY), "head dim 64"),
    ("vivit", dict(dim_head=64, heads=1, dim=64, mlp_dim=128), "D in (768, 1024)"),
    ("vivit", dict(mlp_dim=3000), "M a multiple of 256"),
    ("vivit", dict(compute_dtype="float32"), "bf16 compute dtype"),
])
def test_each_limit_is_named(family, kw, words):
    if family == "vivit":
        limit = vivit.kernel_limits(ViViTConfig(**kw))
    elif family == "conv":
        limit = conv_pyramid.kernel_limits(Wav2Vec2Config(**kw), mega=True)
    else:
        limit = wav2vec2.kernel_limits(Wav2Vec2Config(**kw), True,
                                       family == "wav2vec2_flash", True)
    assert limit is not None and words in limit, limit


def test_a_400_tap_first_layer_takes_the_per_layer_route():
    """``supports_config`` (and its agreement with the JAX function) does not
    change: the family includes any first layer.  The whole-pyramid kernel
    refuses more than MAX_FIRST_TAPS taps; the per-layer route takes them."""
    cfg = Wav2Vec2Config(**FIRST_400)
    assert supports_config(cfg)
    assert "mega=False takes any" in conv_pyramid.kernel_limits(cfg, mega=True)
    assert conv_pyramid.kernel_limits(cfg, mega=False) is None
    assert wav2vec2.kernel_limits(cfg, True, True, False) is None
    ConvFeatureEncoder(cfg, device="cpu", mega=True)  # the CPU takes any config
    with pytest.raises(ValueError, match=f"at most {MAX_FIRST_TAPS}"):
        Wav2Vec2Encoder(cfg, device="cuda", mega=True)


@pytest.mark.parametrize("build,words", [
    (lambda: ConvFeatureEncoder(Wav2Vec2Config(**W2V2_TINY), device="cuda"),
     "ConvFeatureEncoder: the conv kernels take 512 channels"),
    (lambda: ConvFeatureEncoder(Wav2Vec2Config(**FIRST_400), device="cuda"),
     "ConvFeatureEncoder: the mega=True layer-0 kernel"),
    (lambda: Wav2Vec2Encoder(Wav2Vec2Config(hidden_dim=512, num_heads=8), device="cuda"),
     "Wav2Vec2Encoder: the FFN kernel takes D"),
    (lambda: Wav2Vec2Encoder(Wav2Vec2Config(num_conv_pos_embedding_groups=8),
                             device="cuda"),
     "Wav2Vec2Encoder: the positional-conv kernel takes groups of 64 channels"),
    (lambda: AudioEmbedder(Wav2Vec2Config(num_conv_pos_embeddings=129), device="cuda"),
     "the positional-conv kernel takes at most 128 taps"),
    (lambda: AudioEmbedder(Wav2Vec2Config(num_heads=8), device="cuda",
                           use_flash_attn=True),
     "Wav2Vec2Encoder: the attention kernel takes head dim 64"),
    (lambda: AudioEmbedder(Wav2Vec2Config(**W2V2_TINY), device="cuda"),
     "512 channels"),
    (lambda: ViViTFeatureExtractor(ViViTConfig(**VIVIT_TINY), device="cuda"),
     "ViViTFeatureExtractor: the attention kernel takes head dim 64"),
    (lambda: VideoFeatureExtractor(ViViTConfig(mlp_dim=3000), device="cuda"),
     "M a multiple of 256"),
])
def test_models_refuse_at_construction_on_cuda(build, words):
    with pytest.raises(ValueError, match="use_kernels=False") as err:
        build()
    assert words in str(err.value)


def test_the_plain_path_and_the_cpu_take_every_config():
    """No refusal without kernels on the card, nor on the CPU, where the
    wrappers run their plain versions; flash attention alone is held to its
    own limit."""
    tiny = Wav2Vec2Config(**W2V2_TINY)
    assert wav2vec2.kernel_limits(tiny, False, False) is None
    Wav2Vec2Encoder(tiny, device="cpu")
    ViViTFeatureExtractor(ViViTConfig(**VIVIT_TINY), device="cpu")
    assert "head dim 64" in wav2vec2.kernel_limits(tiny, False, True)
    odd = dataclasses.replace(Wav2Vec2Config(), compute_dtype="float32")
    assert "bf16 compute dtype" in wav2vec2.kernel_limits(odd, False, True)
