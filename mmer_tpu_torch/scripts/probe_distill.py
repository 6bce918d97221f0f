"""Ensemble distillation: one student model against the ensemble band, the
port of ``scripts/probe_distill.py``.

    python3 -m mmer_tpu_torch.scripts.probe_distill --video_feat_dir DIR \\
        --audio_feat_dir DIR [--pool_seeds 4] [--student_seeds 4] \\
        [--epochs 400] [--teacher_k 8] [--grid 0.5:1,0.5:2] [--out FILE]

Stage 1: four recipes x ``--pool_seeds`` seeds through
``train/fused.train_many_seeds``; the teacher is the mean-probability blend
of the top ``--teacher_k`` pooled members by validation loss, scored on the
test split, beside a uniform soup of the winning recipe's members (a control
expected to fail).  Stage 2: the teacher's soft targets
(``train/distill.teacher_soft_targets``) and, a student a ``alpha:T`` of
``--grid``, ``--student_seeds`` seeds from seed 100 trained on
``(1-alpha) * hard CE + alpha * T^2 * soft CE``.  Prints a line a stage and
the summary as JSON, writes the summary to ``--out`` only if given (the JAX
script's default path is a committed file) and returns it.  Trains on the
GPU (``--device cpu`` for a rehearsal).
"""

from __future__ import annotations

import argparse
import json
import os

import numpy as np

from mmer_tpu_torch.scripts.quality import add_data_args, load, scratch_dir
from mmer_tpu_torch.scripts.make_flagship import RECIPES


def stats(outs):
    """(best-epoch F1 mean, std, validation-selected F1 mean, std)."""
    be, vs = [], []
    for o in outs:
        rows = o["results"]
        be.append(max(r["test_macro_f1"] for r in rows))
        vs.append(rows[o["best_epoch"] - 1]["test_macro_f1"])
    return (float(np.mean(be)), float(np.std(be)),
            float(np.mean(vs)), float(np.std(vs)))


def main(argv=None) -> dict:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--pool_seeds", type=int, default=4)
    parser.add_argument("--student_seeds", type=int, default=4)
    parser.add_argument("--epochs", type=int, default=400)
    parser.add_argument("--seeds_per_call", type=int, default=4)
    parser.add_argument("--epochs_per_call", type=int, default=100)
    parser.add_argument("--teacher_k", type=int, default=8)
    parser.add_argument("--grid", default="0.5:1,0.5:2,1.0:2,0.8:2",
                        help="comma list of alpha:temperature students")
    parser.add_argument("--out", default=None,
                        help="summary JSON path (default: none written)")
    add_data_args(parser)
    args = parser.parse_args(argv)

    from mmer_tpu_torch.config import ModelConfig, TrainConfig
    from mmer_tpu_torch.train.distill import teacher_soft_targets
    from mmer_tpu_torch.train.ensemble import ensemble_eval, soup_params
    from mmer_tpu_torch.train.fused import train_many_seeds

    device, data, splits = load(args)
    base_m = dict(max_seq_len=data.max_chunks + 1,
                  fusion_dropout=0.2, classifier_dropout=0.2)
    base_t = dict(num_epochs=args.epochs, lr=1e-5, weight_decay=5e-3,
                  label_smoothing=0.1, save_checkpoints=False,
                  output_dir=scratch_dir("distill_probe"))
    model_cfg = ModelConfig(**base_m)
    summary = {}

    # Stage 1: the teacher pool.
    pooled = []              # (best_score, best_params) across all recipes
    winning_members = None   # same-recipe members for the soup control
    for tag, m_over, t_over in RECIPES:
        outs = train_many_seeds(data, splits, ModelConfig(**{**base_m, **m_over}),
                                TrainConfig(**{**base_t, **t_over}),
                                batch_size=64,
                                seeds=list(range(args.pool_seeds)),
                                seeds_per_call=args.seeds_per_call,
                                epochs_per_call=args.epochs_per_call,
                                verbose=False, device=device)
        bm, bs, vm, vs = stats(outs)
        print(f"pool {tag:10s} best-epoch {bm:.4f}±{bs:.4f} "
              f"val-sel {vm:.4f}±{vs:.4f}", flush=True)
        pooled.extend((o["best_score"], o["best_params"]) for o in outs)
        if tag == "winning":
            winning_members = [o["best_params"] for o in outs]

    pooled.sort(key=lambda t: t[0])
    teachers = [p for _, p in pooled[:args.teacher_k]]
    t_res = ensemble_eval(model_cfg, teachers, data, splits, "test",
                          device=device)
    summary["teacher_test_f1"] = round(t_res["ensemble_macro_f1"], 4)
    print(f"teacher (pooled top-{args.teacher_k} of {len(pooled)}): "
          f"test F1 {t_res['ensemble_macro_f1']:.4f}", flush=True)

    # The soup control.
    soup = soup_params(winning_members)
    s_res = ensemble_eval(model_cfg, [soup], data, splits, "test",
                          device=device)
    summary["soup_same_recipe_k4"] = round(s_res["ensemble_macro_f1"], 4)
    print(f"soup control (winning recipe, {len(winning_members)} members): "
          f"test F1 {s_res['ensemble_macro_f1']:.4f}", flush=True)

    # Stage 2: distilled students.
    soft = teacher_soft_targets(model_cfg, teachers, data, device=device)
    acc = (soft[splits.train].argmax(1) == data.labels[splits.train]).mean()
    print(f"teacher soft targets: {soft.shape}, train-split teacher acc "
          f"{acc:.4f}", flush=True)
    for spec in args.grid.split(","):
        a_str, t_str = spec.split(":")
        alpha, temp = float(a_str), float(t_str)
        tc = TrainConfig(**base_t, distill_alpha=alpha, distill_temp=temp)
        outs = train_many_seeds(data, splits, model_cfg, tc, batch_size=64,
                                seeds=list(range(100, 100 + args.student_seeds)),
                                seeds_per_call=args.seeds_per_call,
                                epochs_per_call=args.epochs_per_call,
                                verbose=False, soft_targets=soft, device=device)
        bm, bs, vm, vs = stats(outs)
        key = f"student:a{alpha}:T{temp}"
        summary[key] = {"best_epoch_f1": round(bm, 4),
                        "best_epoch_std": round(bs, 4),
                        "val_selected_f1": round(vm, 4),
                        "val_selected_std": round(vs, 4)}
        print(f"{key:20s} best-epoch {bm:.4f}±{bs:.4f} "
              f"val-sel {vm:.4f}±{vs:.4f}", flush=True)

    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
        with open(args.out, "w") as f:
            json.dump(summary, f, indent=1)
    print(json.dumps(summary))
    return summary


if __name__ == "__main__":
    main()
