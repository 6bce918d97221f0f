"""Seed-batched statistical sweep of one recipe, the port of
``scripts/seed_sweep.py``.

    python3 -m mmer_tpu_torch.scripts.seed_sweep --video_feat_dir DIR \\
        --audio_feat_dir DIR [--seeds 8] [--ref-recipe] [--out_dir DIR] \\
        [--ensemble_k 2,4,8] [--ensemble_greedy]

N seeds of one configuration through ``train/fused.train_many_seeds``
(``--seeds_per_call`` seeds share one batched program).  Per seed: the
best-epoch and the validation-selected test macro-F1; with ``--out_dir``
one results JSON a seed and ``summary_<recipe>.json`` (the JAX script's
schema); ``--ensemble_k`` also scores the mean-probability blend of the top
k seeds by validation loss, ``--ensemble_greedy`` the greedy selection.
Trains on the GPU (``--device cpu`` for a rehearsal; without CUDA the
default raises).  ``--epochs_per_call`` is accepted and changes nothing.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os

import numpy as np

from mmer_tpu_torch.config import DataConfig, ModelConfig, TrainConfig


def main(argv=None) -> dict:
    """Runs the sweep; returns the summary."""
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--seeds", type=int, default=8)
    parser.add_argument("--epochs", type=int, default=400)
    parser.add_argument("--seeds_per_call", type=int, default=4)
    parser.add_argument("--epochs_per_call", type=int, default=100)
    parser.add_argument("--ref-recipe", action="store_true",
                        help="the reference's exact recipe (wd 1e-4, no "
                             "dropout bump/label smoothing) instead of "
                             "the winning regularized one")
    parser.add_argument("--out_dir", default=None,
                        help="write one results JSON per seed (reference "
                             "training_runs_2/*.json schema: config + "
                             "per-epoch rows) plus summary.json")
    parser.add_argument("--ensemble_k", default="",
                        help="comma-separated k values: also score the "
                             "mean-probability blend of the top-k members "
                             "ranked by val loss (train/ensemble.py)")
    parser.add_argument("--ensemble_greedy", action="store_true",
                        help="also score the greedy (val-blend F1) "
                             "member selection over all seeds "
                             "(train/ensemble.py greedy_ensemble_eval)")
    parser.add_argument("--video_feat_dir", default=DataConfig.video_feat_dir)
    parser.add_argument("--audio_feat_dir", default=DataConfig.audio_feat_dir)
    parser.add_argument("--device", default="cuda",
                        help="cuda (default; raises without a GPU) or cpu")
    args = parser.parse_args(argv)

    from mmer_tpu_torch.data.pipeline import load_dataset
    from mmer_tpu_torch.scripts.timing import resolve_device
    from mmer_tpu_torch.train.fused import train_many_seeds

    device = resolve_device(args.device)
    data, splits = load_dataset(DataConfig(video_feat_dir=args.video_feat_dir,
                                           audio_feat_dir=args.audio_feat_dir))
    if args.ref_recipe:
        model_cfg = ModelConfig(max_seq_len=data.max_chunks + 1)
        train_cfg = TrainConfig(num_epochs=args.epochs, lr=1e-5,
                                save_checkpoints=False)
    else:
        model_cfg = ModelConfig(max_seq_len=data.max_chunks + 1,
                                fusion_dropout=0.2, classifier_dropout=0.2)
        train_cfg = TrainConfig(num_epochs=args.epochs, lr=1e-5,
                                weight_decay=5e-3, label_smoothing=0.1,
                                save_checkpoints=False)
    recipe = "reference" if args.ref_recipe else "winning"

    outs = train_many_seeds(data, splits, model_cfg, train_cfg,
                            batch_size=64, seeds=list(range(args.seeds)),
                            seeds_per_call=args.seeds_per_call,
                            epochs_per_call=args.epochs_per_call,
                            device=device)

    best_f1, val_f1 = [], []
    for o in outs:
        rows = o["results"]
        best = max(rows, key=lambda r: r["test_macro_f1"])
        sel = min(rows, key=lambda r: r["val_loss"])
        best_f1.append(best["test_macro_f1"])
        val_f1.append(sel["test_macro_f1"])
        print(f"seed {o['seed']}: epochs {len(rows)} "
              f"best-epoch F1 {best['test_macro_f1']:.4f} "
              f"val-selected {sel['test_macro_f1']:.4f}", flush=True)
        if args.out_dir:
            os.makedirs(args.out_dir, exist_ok=True)
            path = os.path.join(args.out_dir,
                                f"results_{'ref' if args.ref_recipe else 'winning'}"
                                f"_seed{o['seed']}.json")
            with open(path, "w") as f:
                json.dump({
                    "seed": o["seed"],
                    "recipe": recipe,
                    "model_config": dataclasses.asdict(model_cfg),
                    "train_config": dataclasses.asdict(train_cfg),
                    "batch_size": 64,
                    "best_epoch": {"epoch": rows.index(best) + 1, **best},
                    "val_selected": {"epoch": rows.index(sel) + 1, **sel},
                    "training_progress": rows,
                }, f, indent=1)
    summary = {
        "recipe": recipe,
        "seeds": args.seeds,
        "best_epoch_f1_mean": round(float(np.mean(best_f1)), 4),
        "best_epoch_f1_std": round(float(np.std(best_f1)), 4),
        "val_selected_f1_mean": round(float(np.mean(val_f1)), 4),
        "val_selected_f1_std": round(float(np.std(val_f1)), 4),
    }
    # Members ranked by val loss at their best epoch: the k-member pick
    # stays test-blind, like each member's own param selection.
    ranked = [outs[i]["best_params"]
              for i in np.argsort([float(o["best_score"]) for o in outs])]
    if args.ensemble_k:
        from mmer_tpu_torch.train.ensemble import ensemble_eval

        summary["ensemble"] = {}
        for k_str in args.ensemble_k.split(","):
            k = int(k_str)
            if not 2 <= k <= len(ranked):
                print(f"ensemble k={k} SKIPPED (needs 2 <= k <= "
                      f"{len(ranked)} trained seeds)", flush=True)
                summary["ensemble"][f"k={k}"] = "skipped"
                continue
            res = ensemble_eval(model_cfg, ranked[:k], data, splits, "test",
                                device=device)
            row = {"macro_f1": round(res["ensemble_macro_f1"], 4),
                   "accuracy": round(res["ensemble_accuracy"], 4),
                   "member_mean_f1": round(res["member_mean_macro_f1"], 4)}
            summary["ensemble"][f"k={k}"] = row
            print(f"ensemble top-{k} by val: macro-F1 {row['macro_f1']} "
                  f"acc {row['accuracy']}", flush=True)
    if args.ensemble_greedy:
        from mmer_tpu_torch.train.ensemble import greedy_ensemble_eval

        res = greedy_ensemble_eval(model_cfg, ranked, data, splits,
                                   k_max=len(ranked), device=device)
        summary["ensemble_greedy"] = {
            "k_best": res["k_best"],
            "macro_f1": round(res["test_macro_f1"], 4),
            "val_f1_path": res["val_f1_path"]}
        print(f"ensemble greedy (val-blend selection): k_best "
              f"{res['k_best']} test macro-F1 {res['test_macro_f1']:.4f}",
              flush=True)
    if args.out_dir:
        with open(os.path.join(args.out_dir, f"summary_{recipe}.json"), "w") as f:
            json.dump(summary, f, indent=1)
    print(json.dumps(summary))
    return summary


if __name__ == "__main__":
    main()
