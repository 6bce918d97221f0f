"""Multi-seed A/Bs around the winning recipe, the port of
``scripts/probe_recipe_sweep_r4.py``.

    python3 -m mmer_tpu_torch.scripts.probe_recipe_sweep_r4 \\
        --video_feat_dir DIR --audio_feat_dir DIR [--seeds 4] [--epochs 400] \\
        [--only baseline,wd8e-3]

The winning recipe (wd 5e-3, dropout 0.2, label smoothing 0.1, batch 64, lr
1e-5) and eight perturbations of one axis each, every configuration ``--seeds``
seeds through ``train/fused.train_many_seeds``; a row a configuration with
the best-epoch and the validation-selected test macro-F1's mean and
spread.  Prints and returns the rows by best-epoch mean.  Trains on the GPU
(``--device cpu`` for a rehearsal).  ``--epochs_per_call`` is accepted and
changes nothing.
"""

from __future__ import annotations

import argparse
import json

import numpy as np

from mmer_tpu_torch.scripts.quality import (add_data_args, best_f1, load,
                                            scratch_dir, val_selected_f1)

_DROP = {"fusion_dropout": 0.25, "classifier_dropout": 0.25}
# (tag, model overrides, train overrides, batch size)
CONFIGS = [
    ("baseline", {}, {}, 64),
    ("wd8e-3", {}, {"weight_decay": 8e-3}, 64),
    ("wd3e-3", {}, {"weight_decay": 3e-3}, 64),
    ("drop0.25", _DROP, {}, 64),
    ("drop0.15", {"fusion_dropout": 0.15, "classifier_dropout": 0.15}, {}, 64),
    ("ls0.15", {}, {"label_smoothing": 0.15}, 64),
    ("lr2e-5", {}, {"lr": 2e-5}, 64),
    ("bs32", {}, {}, 32),
    ("3layers", {"fusion_layers": 3}, {}, 64),
]


def main(argv=None) -> list:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--seeds", type=int, default=4)
    parser.add_argument("--epochs", type=int, default=400)
    parser.add_argument("--seeds_per_call", type=int, default=4)
    parser.add_argument("--epochs_per_call", type=int, default=100)
    parser.add_argument("--only", default="",
                        help="comma-separated tags to run (default all)")
    add_data_args(parser)
    args = parser.parse_args(argv)

    from mmer_tpu_torch.config import ModelConfig, TrainConfig
    from mmer_tpu_torch.train.fused import train_many_seeds

    device, data, splits = load(args)
    base_m = dict(max_seq_len=data.max_chunks + 1,
                  fusion_dropout=0.2, classifier_dropout=0.2)
    base_t = dict(num_epochs=args.epochs, lr=1e-5, weight_decay=5e-3,
                  label_smoothing=0.1, save_checkpoints=False,
                  output_dir=scratch_dir("recipe_sweep_r4"))
    only = set(filter(None, args.only.split(",")))

    board = []
    for tag, m_over, t_over, bs in CONFIGS:
        if only and tag not in only:
            continue
        outs = train_many_seeds(data, splits, ModelConfig(**{**base_m, **m_over}),
                                TrainConfig(**{**base_t, **t_over}),
                                batch_size=bs, seeds=list(range(args.seeds)),
                                seeds_per_call=args.seeds_per_call,
                                epochs_per_call=args.epochs_per_call,
                                verbose=False, device=device)
        best, sel = best_f1(outs), val_selected_f1(outs)
        row = {"tag": tag, "batch_size": bs, "seeds": args.seeds,
               "best_epoch_f1_mean": round(float(np.mean(best)), 4),
               "best_epoch_f1_std": round(float(np.std(best)), 4),
               "val_selected_f1_mean": round(float(np.mean(sel)), 4),
               "val_selected_f1_std": round(float(np.std(sel)), 4)}
        board.append(row)
        print(f"{tag:12s} best {row['best_epoch_f1_mean']:.4f}"
              f"±{row['best_epoch_f1_std']:.4f}  "
              f"val-sel {row['val_selected_f1_mean']:.4f}"
              f"±{row['val_selected_f1_std']:.4f}", flush=True)

    board.sort(key=lambda r: -r["best_epoch_f1_mean"])
    print(json.dumps(board))
    return board


if __name__ == "__main__":
    main()
