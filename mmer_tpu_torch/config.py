"""Configuration dataclasses of the clip, extraction and training paths.

Copied from ``mmer_tpu/config.py`` rather than imported: the PyTorch port
must run where JAX is not installed, and modules under ``mmer_tpu`` reach
JAX through their packages' ``__init__`` (``mmer_tpu.core`` imports
``core.mesh``, which imports jax).  A test holds these copies field for
field to the originals.
"""

from __future__ import annotations

import dataclasses
import json
from dataclasses import dataclass
from typing import Any

import torch

# Canonical label order (reference back-end/app/libs/inference.py:21).
LABELS = ("NEU", "HAP", "SAD", "ANG", "FEA", "DIS")
NUM_CLASSES = len(LABELS)


def torch_dtype(cfg) -> torch.dtype:
    """The torch dtype a config's ``compute_dtype`` names ("bfloat16" or
    "float32")."""
    return torch.bfloat16 if cfg.compute_dtype == "bfloat16" else torch.float32


def compute_dtype_limit(cfg) -> str | None:
    """The CUDA kernels' limit on a config's compute dtype (bf16 operands),
    as a sentence naming it; None if the config keeps it."""
    if cfg.compute_dtype != "bfloat16":
        return f"the CUDA kernels take a bf16 compute dtype, not {cfg.compute_dtype}"
    return None


@dataclass(frozen=True)
class ModelConfig:
    """CrossModalFusion + EmotionClassifier hyperparameters (the canonical
    v2 training invocation, reference train2.py:965-976)."""

    video_dim: int = 768
    audio_dim: int = 1024
    fused_dim: int = 512
    num_classes: int = NUM_CLASSES
    max_seq_len: int = 6  # max video chunks + 1 audio token (train2.py:963)
    fusion_layers: int = 2
    fusion_heads: int = 8
    fusion_ffn_dim: int = 2048  # 4 * fused_dim (train2.py:114)
    fusion_dropout: float = 0.1
    classifier_hidden_dim: int = 512
    classifier_dropout: float = 0.1
    # "layernorm" = v2 semantics (train2.py:104-105); "batchnorm" = v1
    # semantics (reference train.py:50-51).
    norm: str = "layernorm"
    # Compute dtype for the fused transformer.  Params stay float32.
    compute_dtype: str = "bfloat16"


@dataclass(frozen=True)
class DataConfig:
    """Feature-dataset configuration.

    ``pairing='key'`` pairs video and audio artifacts by sample key;
    ``pairing='positional'`` reproduces the reference's ``zip(sorted, sorted)``
    (train2.py:315-325) for comparisons.  The two directory defaults are
    relative paths here (the JAX package's point at its own data mount).
    """

    video_feat_dir: str = "video_features"
    audio_feat_dir: str = "audio_features"
    batch_size: int = 64
    seed: int = 42
    pairing: str = "key"
    # v1 trainer oversamples NEU to the majority count (train.py:199-211).
    oversample_neutral: bool = False
    # Mild class-weight boost for FEA/DIS (train2.py:484-486).
    boost_classes: tuple = (4, 5)
    boost_factor: float = 1.2
    # Normalization: "global" per-dim over the dataset (train2.py:362-378)
    # or "per_sample" (v1, train.py:176-177).
    normalization: str = "global"


@dataclass(frozen=True)
class TrainConfig:
    """Optimization loop configuration (reference train2.py:495-774).  The
    opt-in fields ``ema_decay``, ``mixup_alpha``, ``modality_dropout`` and
    ``distill_alpha`` are carried so that configs stay interchangeable with
    the JAX package's; the port's trainer raises on a non-zero value."""

    num_epochs: int = 100
    lr: float = 1e-4
    weight_decay: float = 1e-4
    clip_norm: float = 1.0
    # Early stopping: stop after `patience` epochs whose val-loss improvement
    # over the previous epoch is < min_delta (train2.py:622-633).
    patience: int = 8
    min_delta: float = 1e-4
    # ReduceLROnPlateau on val loss (train2.py:526).
    scheduler_factor: float = 0.3
    scheduler_patience: int = 20
    # "weighted_ce" (v2, train2.py:523) or "focal" (v1, train.py:251).
    loss: str = "weighted_ce"
    focal_gamma: float = 2.0
    # Opt-in improvement beyond the reference (0.0 = exact reference loss).
    label_smoothing: float = 0.0
    ema_decay: float = 0.0
    mixup_alpha: float = 0.0
    modality_dropout: float = 0.0
    distill_alpha: float = 0.0
    distill_temp: float = 1.0
    # Best-model selection: "val_loss" (v2, train2.py:617-620) or
    # "val_acc" (v1, train.py:334-338).
    best_metric: str = "val_loss"
    output_dir: str = "training_runs_2"
    save_checkpoints: bool = True
    # Periodic full-state (params + optimizer + generator) checkpoints for
    # mid-run resume; 0 disables.
    checkpoint_every: int = 0
    eval_test_every_epoch: bool = True
    log_every: int = 1


@dataclass(frozen=True)
class MeshConfig:
    """Device-mesh layout: a (data, model) mesh over the ranks of a
    ``torch.distributed`` world (:func:`mmer_tpu_torch.core.mesh.create_mesh`).
    data = batch sharding, model = tensor-parallel sharding of the fusion
    model's attention heads and FFN columns."""

    data_axis: str = "data"
    model_axis: str = "model"
    # -1 = all available devices on the data axis, model axis 1.
    data_parallel: int = -1
    model_parallel: int = 1


@dataclass(frozen=True)
class ViViTConfig:
    """ViViT feature-extractor hyperparameters (reference video_extractor.py:83)."""

    image_size: tuple = (224, 224)
    patch_size: tuple = (16, 16)
    num_frames: int = 32
    tubelet_size: int = 4
    dim: int = 768
    depth: int = 12
    heads: int = 12
    dim_head: int = 64
    mlp_dim: int = 3072
    pool: str = "cls"
    in_channels: int = 3
    # The weights are a fixed random projection drawn from this seed.
    param_seed: int = 0
    compute_dtype: str = "bfloat16"


@dataclass(frozen=True)
class Wav2Vec2Config:
    """Wav2Vec2-large, robust variant (HF
    ``audeering/wav2vec2-large-robust-12-ft-emotion-msp-dim``): layer-norm
    feature encoder, stable layer norm, 24 layers, hidden 1024."""

    hidden_dim: int = 1024
    num_layers: int = 24
    num_heads: int = 16
    ffn_dim: int = 4096
    conv_dims: tuple = (512, 512, 512, 512, 512, 512, 512)
    conv_strides: tuple = (5, 2, 2, 2, 2, 2, 2)
    conv_kernels: tuple = (10, 3, 3, 3, 3, 2, 2)
    num_conv_pos_embeddings: int = 128
    num_conv_pos_embedding_groups: int = 16
    do_stable_layer_norm: bool = True
    feat_extract_norm: str = "layer"
    sample_rate: int = 16000
    chunk_duration_s: float = 10.0  # voice_extractor.py:20
    param_seed: int = 1
    compute_dtype: str = "bfloat16"


@dataclass(frozen=True)
class WavLMConfig(Wav2Vec2Config):
    """WavLM-Large (HF ``microsoft/wavlm-large``, arXiv:2110.13900): the
    Wav2Vec2-large encoder at the same widths, with a conv encoder without
    biases and a gated relative position bias in every layer's attention
    (``num_buckets`` buckets of the key's offset from the query, log-spaced
    beyond half of a direction's buckets up to ``max_bucket_distance``)."""

    num_buckets: int = 320
    max_bucket_distance: int = 800
    conv_bias: bool = False


def asdict(cfg: Any) -> dict:
    return dataclasses.asdict(cfg)


def to_json(cfg: Any) -> str:
    return json.dumps(dataclasses.asdict(cfg), indent=2, default=str)
