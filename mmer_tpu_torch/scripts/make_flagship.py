"""One command → the deployable single model, the port of
``scripts/make_flagship.py``.

    python3 -m mmer_tpu_torch.scripts.make_flagship \\
        --video_feat_dir DIR --audio_feat_dir DIR [--out_dir artifacts/flagship]

Every choice is the JAX script's measured recipe; there is no search:

  1. POOL     4 statistically tied recipes × ``--pool_seeds`` seeds, each
              recipe one seed-batched call a ``--seeds_per_call`` seeds
              (``train/fused.train_many_seeds``)
  2. TEACHER  the pool's top half by validation loss, blended by mean
              probability
  3. STUDENT  the winning recipe distilled from the teacher at alpha 0.5,
              T 1, × ``--student_seeds`` seeds; the student with the best
              validation loss is the flagship (selection never reads test)
  4. SAVE     <out_dir>/flagship.msgpack (a flax params tree, the JAX
              package's format: either package serves it), norm_stats.npz
              and manifest.json with the JAX script's keys

Serve it: ``python3 -m mmer_tpu_torch.serve.app`` with
``MMER_FLAGSHIP_DIR=<out_dir>``, or ``--fusion_params
<out_dir>/flagship.msgpack --norm_stats <out_dir>/norm_stats.npz``.  Trains
on the GPU (``--device cpu`` for a rehearsal; without CUDA the default
raises).  ``--epochs_per_call`` is accepted and changes nothing
(``train_many_seeds``).
"""

from __future__ import annotations

import argparse
import json
import os

import numpy as np

from mmer_tpu_torch.config import DataConfig, ModelConfig, TrainConfig

RECIPES = [
    ("winning", {}, {}),
    ("ls0.15", {}, {"label_smoothing": 0.15}),
    ("wd3e-3", {}, {"weight_decay": 3e-3}),
    ("drop0.25", {"fusion_dropout": 0.25, "classifier_dropout": 0.25}, {}),
]


def main(argv=None) -> dict:
    """Runs the pipeline; returns ``{"manifest", "pool", "soft_targets",
    "students", "flagship", "configs", "dataset"}``: the pool's (by recipe)
    and the students' ``train_many_seeds`` outputs, the teacher's targets,
    the chosen student, each recipe's (ModelConfig, TrainConfig) and the
    loaded (data, splits)."""
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--pool_seeds", type=int, default=4)
    parser.add_argument("--student_seeds", type=int, default=4)
    parser.add_argument("--epochs", type=int, default=400)
    parser.add_argument("--seeds_per_call", type=int, default=4)
    parser.add_argument("--epochs_per_call", type=int, default=100)
    parser.add_argument("--distill_alpha", type=float, default=0.5)
    parser.add_argument("--distill_temp", type=float, default=1.0)
    parser.add_argument("--out_dir", default="artifacts/flagship")
    parser.add_argument("--video_feat_dir", default=DataConfig.video_feat_dir)
    parser.add_argument("--audio_feat_dir", default=DataConfig.audio_feat_dir)
    parser.add_argument("--device", default="cuda",
                        help="cuda (default; raises without a GPU) or cpu")
    args = parser.parse_args(argv)

    from mmer_tpu_torch.data.pipeline import load_dataset
    from mmer_tpu_torch.models.convert import fusion_to_flax
    from mmer_tpu_torch.scripts.timing import resolve_device
    from mmer_tpu_torch.train.checkpoint import save_params_msgpack
    from mmer_tpu_torch.train.distill import teacher_soft_targets
    from mmer_tpu_torch.train.ensemble import ensemble_eval
    from mmer_tpu_torch.train.fused import train_many_seeds

    device = resolve_device(args.device)
    data, splits = load_dataset(DataConfig(video_feat_dir=args.video_feat_dir,
                                           audio_feat_dir=args.audio_feat_dir))
    base_m = dict(max_seq_len=data.max_chunks + 1,
                  fusion_dropout=0.2, classifier_dropout=0.2)
    base_t = dict(num_epochs=args.epochs, lr=1e-5, weight_decay=5e-3,
                  label_smoothing=0.1, save_checkpoints=False,
                  output_dir=os.path.join(args.out_dir, "runs"))
    model_cfg = ModelConfig(**base_m)
    manifest = {"pipeline": "pool -> top-half teacher -> distilled student",
                "recipes": [r[0] for r in RECIPES],
                "pool_seeds": args.pool_seeds,
                "student_seeds": args.student_seeds,
                "distill_alpha": args.distill_alpha,
                "distill_temp": args.distill_temp}

    def many(mc, tc, seeds, soft=None):
        return train_many_seeds(data, splits, mc, tc, batch_size=64,
                                seeds=seeds, seeds_per_call=args.seeds_per_call,
                                epochs_per_call=args.epochs_per_call,
                                verbose=False, soft_targets=soft, device=device)

    # 1. pool --------------------------------------------------------------
    pool, pooled, configs = [], [], {}
    for tag, m_over, t_over in RECIPES:
        configs[tag] = (ModelConfig(**{**base_m, **m_over}),
                        TrainConfig(**{**base_t, **t_over}))
        outs = many(*configs[tag], list(range(args.pool_seeds)))
        pool.append((tag, outs))
        pooled.extend((o["best_score"], o["best_params"]) for o in outs)
        print(f"pool {tag}: {len(outs)} members", flush=True)

    # 2. teacher -----------------------------------------------------------
    pooled.sort(key=lambda t: t[0])
    k = max(1, len(pooled) // 2)
    teachers = [p for _, p in pooled[:k]]
    t_res = ensemble_eval(model_cfg, teachers, data, splits, "test",
                          device=device)
    manifest["teacher_members"] = k
    manifest["teacher_test_macro_f1"] = round(t_res["ensemble_macro_f1"], 4)
    print(f"teacher top-{k}-of-{len(pooled)}: "
          f"test F1 {t_res['ensemble_macro_f1']:.4f}", flush=True)

    # 3. student -----------------------------------------------------------
    soft = teacher_soft_targets(model_cfg, teachers, data, device=device)
    tc = TrainConfig(**base_t, distill_alpha=args.distill_alpha,
                     distill_temp=args.distill_temp)
    outs = many(model_cfg, tc, list(range(100, 100 + args.student_seeds)), soft)
    best = min(outs, key=lambda o: o["best_score"])   # val loss, test-blind
    sel_row = best["results"][best["best_epoch"] - 1]
    manifest["student_val_selected"] = {
        "seed": best["seed"], "epoch": best["best_epoch"],
        "test_macro_f1": round(sel_row["test_macro_f1"], 4),
        "test_acc": round(sel_row["test_acc"], 2),
        "val_loss": round(float(best["best_score"]), 6)}
    manifest["student_seed_stats"] = {
        "val_selected_f1_mean": round(float(np.mean(
            [o["results"][o["best_epoch"] - 1]["test_macro_f1"]
             for o in outs])), 4),
        "best_epoch_f1_mean": round(float(np.mean(
            [max(r["test_macro_f1"] for r in o["results"])
             for o in outs])), 4)}
    print(f"flagship student: seed {best['seed']} epoch "
          f"{best['best_epoch']} val-selected test F1 "
          f"{sel_row['test_macro_f1']:.4f} acc {sel_row['test_acc']:.2f}%",
          flush=True)

    # 4. save --------------------------------------------------------------
    os.makedirs(args.out_dir, exist_ok=True)
    ckpt = os.path.join(args.out_dir, "flagship.msgpack")
    save_params_msgpack(ckpt, fusion_to_flax(best["best_params"],
                                             model_cfg.fusion_heads))
    if data.video_mean is not None:
        np.savez(os.path.join(args.out_dir, "norm_stats.npz"),
                 video_mean=data.video_mean, video_std=data.video_std,
                 audio_mean=data.audio_mean, audio_std=data.audio_std)
    manifest["checkpoint"] = ckpt
    manifest["model_config"] = base_m
    with open(os.path.join(args.out_dir, "manifest.json"), "w") as f:
        json.dump(manifest, f, indent=1)
    print(json.dumps(manifest))
    return {"manifest": manifest, "pool": pool, "soft_targets": soft,
            "students": outs, "flagship": best, "configs": configs,
            "dataset": (data, splits)}


if __name__ == "__main__":
    main()
