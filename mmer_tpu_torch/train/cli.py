"""Training CLI: reference-compatible flags (train2.py:941-946) plus the
knobs the reference hardcodes; the port of ``mmer_tpu/train/cli.py``.

    python3 -m mmer_tpu_torch.train.cli --video_feat_dir DIR --audio_feat_dir DIR \\
        --batch_size 64 --num_epochs 300 --lr 1e-5

Feature folders (``*_faces_mp4_features.npy`` (T, 768) float32 and
``*_voice_mp4_features.npy`` (1024,) float16, as the extraction CLI writes
them) → ``results_*.json``, ``best_model_*.pth``, ``final_model_*.pth`` and
``norm_stats_*.npz`` under ``--output_dir``.  Trains on the GPU unless
``--device cpu`` is given; without CUDA the default raises.

The JAX CLI's flags are here with its defaults, apart from ``--fused``: the
port has one trainer, which takes the fused trainer's opt-ins
(``--ema_decay``, ``--mixup_alpha``, ``--modality_dropout``,
``--distill_from``).  ``--raw_videos DIR --raw_audio DIR`` trains on raw
face-crop videos and audio tracks, extracted on ``--device`` straight into
the trainer (``preprocess/extract.py:extract_dataset_arrays``; decoding the
videos needs ``cv2``):

    python3 -m mmer_tpu_torch.train.cli --raw_videos FACES --raw_audio AUDIO

Launched by ``torchrun`` (``python3 -m torch.distributed.run
--nproc_per_node N -m mmer_tpu_torch.train.cli ...``) the run is data
parallel over the world's ranks, one card each (gloo ranks with
``--device cpu``), with ``--batch_size`` the global batch: the JAX CLI's
``MeshConfig()``.  Rank 0 writes the files.
"""

from __future__ import annotations

import argparse

import torch

from mmer_tpu_torch.config import DataConfig, MeshConfig, ModelConfig, TrainConfig
from mmer_tpu_torch.core.mesh import init_from_env, is_writer
from mmer_tpu_torch.data.pipeline import load_dataset
from mmer_tpu_torch.train.loop import TrainOutput, train_model


def main(argv=None) -> TrainOutput:
    p = argparse.ArgumentParser(
        description="Train the multimodal emotion recognition model")
    p.add_argument("--batch_size", type=int, default=128)
    p.add_argument("--num_epochs", type=int, default=100)
    p.add_argument("--lr", type=float, default=1e-4)
    p.add_argument("--video_feat_dir", default=DataConfig.video_feat_dir)
    p.add_argument("--audio_feat_dir", default=DataConfig.audio_feat_dir)
    p.add_argument("--pairing", choices=["key", "positional"], default="key")
    p.add_argument("--loss", choices=["weighted_ce", "focal"],
                   default="weighted_ce")
    p.add_argument("--norm", choices=["layernorm", "batchnorm"],
                   default="layernorm")
    p.add_argument("--normalization", choices=["global", "per_sample"],
                   default="global")
    p.add_argument("--oversample_neutral", action="store_true")
    p.add_argument("--output_dir", default="training_runs_2")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--patience", type=int, default=8)
    p.add_argument("--weight_decay", type=float, default=1e-4)
    p.add_argument("--label_smoothing", type=float, default=0.0)
    p.add_argument("--fusion_dropout", type=float, default=0.1)
    p.add_argument("--classifier_dropout", type=float, default=0.1)
    p.add_argument("--best_metric", choices=["val_loss", "val_acc"],
                   default="val_loss",
                   help="best-model selection: val_loss (v2) or val_acc (v1)")
    p.add_argument("--no_test_eval", action="store_true")
    p.add_argument("--resume_dir", default=None,
                   help="directory of state_* checkpoints to resume from "
                        "(written to <output_dir>/checkpoints)")
    p.add_argument("--checkpoint_every", type=int, default=0,
                   help="save full train state every N epochs (0 = off)")
    p.add_argument("--interpret", action="store_true",
                   help="IG feature importances on the test set "
                        "(reference train2.py:990 epilogue — run on the "
                        "BEST params, fixing its final-weights bug)")
    p.add_argument("--profile_dir", default=None,
                   help="capture a torch.profiler trace of the run")
    p.add_argument("--ema_decay", type=float, default=0.0,
                   help="evaluate/select on a per-step EMA of the params "
                        "(0 = off, reference behavior)")
    p.add_argument("--mixup_alpha", type=float, default=0.0,
                   help="mixup over feature pairs, lambda~Beta(a,a) "
                        "(0 = off, reference behavior)")
    p.add_argument("--modality_dropout", type=float, default=0.0,
                   help="per-sample probability of zeroing one modality "
                        "(0 = off, reference behavior)")
    p.add_argument("--distill_from", default=None, metavar="CKPT[,CKPT...]",
                   help="comma-separated fusion checkpoints (.pth or flax "
                        ".msgpack): mean-probability blend them as the "
                        "teacher and train this run as its distilled student "
                        "(see train/distill.py)")
    p.add_argument("--distill_alpha", type=float, default=0.5,
                   help="soft-loss weight when --distill_from is given: "
                        "loss = (1-a)*hard + a*T^2*soft")
    p.add_argument("--distill_temp", type=float, default=1.0,
                   help="distillation temperature T")
    p.add_argument("--raw_videos", default=None, metavar="DIR",
                   help="RAW face-crop videos: extract ViViT features on "
                        "the device straight into the trainer, skipping the "
                        ".npy round trip (requires --raw_audio)")
    p.add_argument("--raw_audio", default=None, metavar="DIR",
                   help="RAW audio tracks for --raw_videos")
    p.add_argument("--device", default="cuda",
                   help="cuda (default; raises without a GPU) or cpu")
    args = p.parse_args(argv)
    if (args.raw_videos is None) != (args.raw_audio is None):
        p.error("--raw_videos and --raw_audio must be given together")
    args.device = init_from_env(args.device)
    say = print if is_writer() else (lambda *a, **k: None)

    data_cfg = DataConfig(
        video_feat_dir=args.video_feat_dir,
        audio_feat_dir=args.audio_feat_dir,
        batch_size=args.batch_size, pairing=args.pairing,
        normalization=args.normalization,
        oversample_neutral=args.oversample_neutral)
    if args.raw_videos:
        from mmer_tpu_torch.preprocess.extract import extract_dataset_arrays

        data, splits = extract_dataset_arrays(
            args.raw_videos, args.raw_audio, data_cfg=data_cfg,
            device=args.device, verbose=is_writer())
    else:
        data, splits = load_dataset(data_cfg)
    say(f"Samples: {data.num_samples}  max_chunks: {data.max_chunks}  "
          f"train/val/test: {len(splits.train)}/{len(splits.val)}/{len(splits.test)}")

    model_cfg = ModelConfig(max_seq_len=data.max_chunks + 1, norm=args.norm,
                            fusion_dropout=args.fusion_dropout,
                            classifier_dropout=args.classifier_dropout)
    train_cfg = TrainConfig(
        num_epochs=args.num_epochs, lr=args.lr, loss=args.loss,
        patience=args.patience, output_dir=args.output_dir,
        eval_test_every_epoch=not args.no_test_eval,
        checkpoint_every=args.checkpoint_every,
        weight_decay=args.weight_decay,
        label_smoothing=args.label_smoothing,
        ema_decay=args.ema_decay,
        mixup_alpha=args.mixup_alpha,
        modality_dropout=args.modality_dropout,
        distill_alpha=args.distill_alpha if args.distill_from else 0.0,
        distill_temp=args.distill_temp,
        best_metric=args.best_metric)

    soft_targets = None
    if args.distill_from:
        from mmer_tpu_torch.train.checkpoint import load_fusion_checkpoint
        from mmer_tpu_torch.train.distill import teacher_soft_targets

        teachers = [load_fusion_checkpoint(path.strip(), model_cfg,
                                           args.device).state_dict()
                    for path in args.distill_from.split(",") if path.strip()]
        say(f"Distilling from {len(teachers)} teacher checkpoint(s), "
              f"alpha={args.distill_alpha} T={args.distill_temp}")
        soft_targets = teacher_soft_targets(model_cfg, teachers, data,
                                            device=args.device)

    from mmer_tpu_torch.utils.profiling import trace

    with trace(args.profile_dir):
        out = train_model(data, splits, model_cfg, train_cfg,
                          batch_size=args.batch_size, seed=args.seed,
                          resume_dir=args.resume_dir, device=args.device,
                          soft_targets=soft_targets, mesh_cfg=MeshConfig())

    if args.interpret and is_writer():
        from mmer_tpu_torch.interpret.ig import interpret_test_set
        from mmer_tpu_torch.models.fusion import MultimodalEmotionModel

        model = MultimodalEmotionModel(model_cfg, device=args.device)
        model.load_state_dict(out.best_params if out.best_params is not None
                              else out.final_params)
        model.eval()

        def logits_fn(v, a, m):
            return model(v, a, m)[1]

        host = {"video": data.video, "audio": data.audio,
                "pad_mask": data.pad_mask, "labels": data.labels}
        interpret_test_set(logits_fn, host, splits.test,
                           output_dir=args.output_dir, device=args.device)

    best = max((r for r in out.results if "test_macro_f1" in r),
               key=lambda r: r["test_macro_f1"], default=None)
    if best:
        say(f"Best epoch by test macro-F1: {best['epoch']} "
              f"(acc {best['test_acc']:.2f}%, macro-F1 {best['test_macro_f1']:.4f})")
    say(f"Best val-loss epoch: {out.best_epoch}")
    return out


if __name__ == "__main__":
    main()
    if torch.distributed.is_initialized():
        torch.distributed.destroy_process_group()
