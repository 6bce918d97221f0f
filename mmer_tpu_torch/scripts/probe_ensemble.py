"""Seed-ensemble quality of the winning recipe, the port of
``scripts/probe_ensemble.py``.

    python3 -m mmer_tpu_torch.scripts.probe_ensemble --video_feat_dir DIR \\
        --audio_feat_dir DIR [--seeds 8] [--epochs 400]

Trains the winning recipe for ``--seeds`` seeds through
``train/fused.train_many_seeds`` and scores the mean-probability ensemble of
the top k seeds by validation loss (k = 2, 4 and all; each member its
validation-selected params) on the test split.  Prints the single-model
band, a line a k and the last ensemble's result as JSON; returns
``{"singles": [...], "ensemble": {"k=2": {...}, ...}}``.  Trains on the GPU
(``--device cpu`` for a rehearsal).
"""

from __future__ import annotations

import argparse
import json

import numpy as np

from mmer_tpu_torch.scripts.quality import (add_data_args, best_f1, load,
                                            scratch_dir)


def main(argv=None) -> dict:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--seeds", type=int, default=8)
    parser.add_argument("--epochs", type=int, default=400)
    parser.add_argument("--seeds_per_call", type=int, default=4)
    parser.add_argument("--epochs_per_call", type=int, default=100)
    add_data_args(parser)
    args = parser.parse_args(argv)

    from mmer_tpu_torch.config import ModelConfig, TrainConfig
    from mmer_tpu_torch.train.ensemble import ensemble_eval
    from mmer_tpu_torch.train.fused import train_many_seeds

    device, data, splits = load(args)
    model_cfg = ModelConfig(max_seq_len=data.max_chunks + 1,
                            fusion_dropout=0.2, classifier_dropout=0.2)
    train_cfg = TrainConfig(num_epochs=args.epochs, lr=1e-5,
                            weight_decay=5e-3, label_smoothing=0.1,
                            save_checkpoints=False,
                            output_dir=scratch_dir("ensemble_probe"))
    outs = train_many_seeds(data, splits, model_cfg, train_cfg,
                            batch_size=64, seeds=list(range(args.seeds)),
                            seeds_per_call=args.seeds_per_call,
                            epochs_per_call=args.epochs_per_call,
                            device=device)

    # Members ranked by validation loss at their best epoch: the k-member
    # pick stays test-blind, like each member's own param selection.
    order = np.argsort([float(o["best_score"]) for o in outs])
    params = [outs[i]["best_params"] for i in order]
    singles = best_f1(outs)
    print(f"single-model best-epoch F1: {np.mean(singles):.4f}"
          f"+/-{np.std(singles):.4f}", flush=True)

    summary = {"singles": singles, "ensemble": {}}
    for k in (2, 4, len(params)):
        if k > len(params):
            break
        res = ensemble_eval(model_cfg, params[:k], data, splits, "test",
                            device=device)
        summary["ensemble"][f"k={k}"] = res
        print(f"ensemble k={k}: macro-F1 {res['ensemble_macro_f1']:.4f} "
              f"acc {res['ensemble_accuracy']:.4f} "
              f"(member mean {res['member_mean_macro_f1']:.4f})", flush=True)
    print(json.dumps(res))
    return summary


if __name__ == "__main__":
    main()
