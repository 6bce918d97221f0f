"""Quality A/B of the feature-space regularisers, mixup and modality
dropout, on top of the winning recipe, the port of
``scripts/probe_mixup_quality.py``.

    python3 -m mmer_tpu_torch.scripts.probe_mixup_quality \\
        --video_feat_dir DIR --audio_feat_dir DIR [--seeds 4] [--epochs 400] \\
        [--arms baseline,mixup0.2] [--out summary.json]

Each arm ``--seeds`` seeds through ``train/fused.train_many_seeds``; a
summary an arm with the best-epoch and the validation-selected test
macro-F1's mean and spread, printed as JSON, written to ``--out`` if given
and returned.  Trains on the GPU (``--device cpu`` for a rehearsal).
"""

from __future__ import annotations

import argparse
import json

import numpy as np

from mmer_tpu_torch.scripts.quality import (add_data_args, best_f1, load,
                                            scratch_dir, val_selected_f1)

# (tag, TrainConfig overrides of the winning recipe)
ARMS = [
    ("baseline", {}),
    ("mixup0.2", {"mixup_alpha": 0.2}),
    ("mixup0.4", {"mixup_alpha": 0.4}),
    ("mdrop0.2", {"modality_dropout": 0.2}),
    ("mixup0.2+mdrop0.2", {"mixup_alpha": 0.2, "modality_dropout": 0.2}),
]


def main(argv=None) -> dict:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--seeds", type=int, default=4)
    parser.add_argument("--epochs", type=int, default=400)
    parser.add_argument("--seeds_per_call", type=int, default=4)
    parser.add_argument("--epochs_per_call", type=int, default=100)
    parser.add_argument("--arms", default=None,
                        help="comma list of arm tags to run (default all)")
    parser.add_argument("--out", default=None, help="summary JSON path")
    add_data_args(parser)
    args = parser.parse_args(argv)

    from mmer_tpu_torch.config import ModelConfig, TrainConfig
    from mmer_tpu_torch.train.fused import train_many_seeds

    device, data, splits = load(args)
    model_cfg = ModelConfig(max_seq_len=data.max_chunks + 1,
                            fusion_dropout=0.2, classifier_dropout=0.2)
    arms = ARMS
    if args.arms:
        keep = set(args.arms.split(","))
        arms = [a for a in arms if a[0] in keep]

    summary = {}
    for tag, over in arms:
        train_cfg = TrainConfig(num_epochs=args.epochs, lr=1e-5,
                                weight_decay=5e-3, label_smoothing=0.1,
                                save_checkpoints=False,
                                output_dir=scratch_dir("mixup_probe"), **over)
        outs = train_many_seeds(data, splits, model_cfg, train_cfg,
                                batch_size=64, seeds=list(range(args.seeds)),
                                seeds_per_call=args.seeds_per_call,
                                epochs_per_call=args.epochs_per_call,
                                device=device)
        best, sel = best_f1(outs), val_selected_f1(outs)
        summary[tag] = {
            "best_epoch_f1_mean": round(float(np.mean(best)), 4),
            "best_epoch_f1_std": round(float(np.std(best)), 4),
            "val_selected_f1_mean": round(float(np.mean(sel)), 4),
            "val_selected_f1_std": round(float(np.std(sel)), 4),
        }
        print(f"{tag}: best {summary[tag]['best_epoch_f1_mean']:.4f}"
              f"±{summary[tag]['best_epoch_f1_std']:.4f}  val-sel "
              f"{summary[tag]['val_selected_f1_mean']:.4f}"
              f"±{summary[tag]['val_selected_f1_std']:.4f}", flush=True)

    print(json.dumps(summary))
    if args.out:
        with open(args.out, "w") as f:
            json.dump(summary, f, indent=1)
    return summary


if __name__ == "__main__":
    main()
