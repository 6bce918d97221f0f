"""Recipe-diverse seed ensembles against same-recipe ones, the port of
``scripts/probe_diverse_ensemble.py``.

    python3 -m mmer_tpu_torch.scripts.probe_diverse_ensemble \\
        --video_feat_dir DIR --audio_feat_dir DIR [--seeds 4] [--epochs 400] \\
        [--greedy]

Four recipes (the winning one; label smoothing 0.15; weight decay 3e-3;
dropout 0.25) x ``--seeds`` seeds through ``train/fused.train_many_seeds``,
then mean-probability blends on the test split, members ranked by
validation loss throughout: (a) each recipe's members, (b) the best member
of each recipe, (c) the top k of the pooled members, and with ``--greedy``
(d) greedy forward selection on the validation blend, with and without
replacement.  Prints a line a blend and the summary as JSON, and returns the
summary.  Trains on the GPU (``--device cpu`` for a rehearsal).
"""

from __future__ import annotations

import argparse
import json

import numpy as np

from mmer_tpu_torch.scripts.quality import (add_data_args, best_f1, load,
                                            scratch_dir)
from mmer_tpu_torch.scripts.make_flagship import RECIPES


def main(argv=None) -> dict:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--seeds", type=int, default=4)
    parser.add_argument("--epochs", type=int, default=400)
    parser.add_argument("--seeds_per_call", type=int, default=4)
    parser.add_argument("--epochs_per_call", type=int, default=100)
    parser.add_argument("--greedy", action="store_true",
                        help="also run greedy forward selection (val-blend "
                             "F1) over the pooled members, against the "
                             "val-loss top-k rank")
    add_data_args(parser)
    args = parser.parse_args(argv)

    from mmer_tpu_torch.config import ModelConfig, TrainConfig
    from mmer_tpu_torch.train.ensemble import ensemble_eval
    from mmer_tpu_torch.train.fused import train_many_seeds

    device, data, splits = load(args)
    base_m = dict(max_seq_len=data.max_chunks + 1,
                  fusion_dropout=0.2, classifier_dropout=0.2)
    base_t = dict(num_epochs=args.epochs, lr=1e-5, weight_decay=5e-3,
                  label_smoothing=0.1, save_checkpoints=False,
                  output_dir=scratch_dir("diverse_ensemble"))

    def blend(params):
        return ensemble_eval(model_cfg, params, data, splits, "test",
                             device=device)["ensemble_macro_f1"]

    # One architecture across recipes (only regularisers differ), so every
    # blend's members share the model config.
    model_cfg = ModelConfig(**base_m)
    per_recipe = {}          # tag -> [(best_score, best_params)], val-ranked
    for tag, m_over, t_over in RECIPES:
        outs = train_many_seeds(data, splits, ModelConfig(**{**base_m, **m_over}),
                                TrainConfig(**{**base_t, **t_over}),
                                batch_size=64, seeds=list(range(args.seeds)),
                                seeds_per_call=args.seeds_per_call,
                                epochs_per_call=args.epochs_per_call,
                                verbose=False, device=device)
        per_recipe[tag] = sorted(((o["best_score"], o["best_params"])
                                  for o in outs), key=lambda t: t[0])
        singles = best_f1(outs)
        print(f"{tag:10s} singles best-epoch {np.mean(singles):.4f}"
              f"±{np.std(singles):.4f}", flush=True)

    summary = {}
    # (a) same-recipe, all members (dropout is off at inference, so a
    # member's recipe only shaped its weights).
    for tag, members in per_recipe.items():
        f1 = blend([p for _, p in members])
        summary[f"same:{tag}:k{len(members)}"] = round(f1, 4)
        print(f"same-recipe {tag} k={len(members)}: {f1:.4f}", flush=True)

    # (b) cross-recipe: the best-val member of each recipe.
    f1 = blend([members[0][1] for members in per_recipe.values()])
    summary["cross:best-of-each:k4"] = round(f1, 4)
    print(f"cross-recipe best-of-each k=4: {f1:.4f}", flush=True)

    # (c) pooled val-ranked top-k over all members.
    pooled = sorted(((s, p) for ms in per_recipe.values() for s, p in ms),
                    key=lambda t: t[0])
    for k in sorted({4, 8, len(pooled) // 2, len(pooled)}):
        if k > len(pooled) or k < 1:
            continue
        f1 = blend([p for _, p in pooled[:k]])
        summary[f"pooled:top{k}"] = round(f1, 4)
        print(f"pooled val-ranked top-{k}: {f1:.4f}", flush=True)

    # (d) greedy forward selection on the validation blend; the pool goes in
    # val-ranked order, so ties prefer better-val members.
    if args.greedy:
        from mmer_tpu_torch.train.ensemble import greedy_ensemble_eval

        pool_params = [p for _, p in pooled]
        for replace in (False, True):
            res = greedy_ensemble_eval(model_cfg, pool_params, data, splits,
                                       k_max=min(16, len(pooled)),
                                       replace=replace, device=device)
            tag = "greedy+rep" if replace else "greedy"
            summary[f"{tag}:k{res['k_best']}"] = res["test_macro_f1"]
            print(f"{tag}: k_best={res['k_best']} "
                  f"val-blend {max(res['val_f1_path']):.4f} "
                  f"test {res['test_macro_f1']:.4f} "
                  f"order {res['order']}", flush=True)

    print(json.dumps(summary))
    return summary


if __name__ == "__main__":
    main()
