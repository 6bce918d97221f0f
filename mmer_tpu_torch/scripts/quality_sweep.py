"""Quality sweep of regularisation and architecture knobs around the
reference configuration, the port of ``scripts/quality_sweep.py``.

    python3 -m mmer_tpu_torch.scripts.quality_sweep --video_feat_dir DIR \\
        --audio_feat_dir DIR [--epochs 300]

Twelve single-seed runs of ``train_model(fused=True)`` at lr 1e-5 and batch
64 (dropout, label smoothing, depth, weight decay, seeds); prints one JSON
row a run and the leaderboard, and returns the rows by best test macro-F1.
``--epochs`` (the JAX script's fixed 300 by default) cuts the depth of a
smoke run.  Trains on the GPU (``--device cpu`` for a rehearsal).
"""

from __future__ import annotations

import argparse
import dataclasses
import json

from mmer_tpu_torch.scripts.quality import add_data_args, load, scratch_dir

_DROP2 = {"fusion_dropout": 0.2, "classifier_dropout": 0.2}
_DROP3 = {"fusion_dropout": 0.3, "classifier_dropout": 0.3}
# (tag, model overrides, train overrides, bs, seed)
CONFIGS = [
    ("ref", {}, {}, 64, 0),
    ("drop0.2", _DROP2, {}, 64, 0),
    ("drop0.3", _DROP3, {}, 64, 0),
    ("ls0.1", {}, {"label_smoothing": 0.1}, 64, 0),
    ("ls0.1-drop0.2", _DROP2, {"label_smoothing": 0.1}, 64, 0),
    ("3layers", {"fusion_layers": 3}, {}, 64, 0),
    ("wd1e-3", {}, {"weight_decay": 1e-3}, 64, 0),
    ("ls0.1-s1", {}, {"label_smoothing": 0.1}, 64, 1),
    ("ls0.1-s2", {}, {"label_smoothing": 0.1}, 64, 2),
    ("drop0.2-s1", _DROP2, {}, 64, 1),
    ("ls0.1-drop0.2-s1", _DROP2, {"label_smoothing": 0.1}, 64, 1),
    ("ls0.05", {}, {"label_smoothing": 0.05}, 64, 0),
]


def main(argv=None) -> list:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--epochs", type=int, default=300)
    add_data_args(parser)
    args = parser.parse_args(argv)

    from mmer_tpu_torch.config import ModelConfig, TrainConfig
    from mmer_tpu_torch.train.loop import train_model

    device, data, splits = load(args)
    base_model = ModelConfig(max_seq_len=data.max_chunks + 1)
    board = []
    for tag, m_over, t_over, bs, seed in CONFIGS:
        model_cfg = dataclasses.replace(base_model, **m_over)
        train_cfg = TrainConfig(num_epochs=args.epochs, lr=1e-5,
                                output_dir=scratch_dir("qsweep"), **t_over)
        out = train_model(data, splits, model_cfg, train_cfg, batch_size=bs,
                          seed=seed, verbose=False, fused=True, device=device)
        best = max((r for r in out.results if "test_macro_f1" in r),
                   key=lambda r: r["test_macro_f1"])
        row = {"tag": tag, "seed": seed, "epochs": len(out.results),
               "best_epoch": best["epoch"],
               "test_acc": round(best["test_acc"], 2),
               "test_macro_f1": round(best["test_macro_f1"], 4)}
        board.append(row)
        print(json.dumps(row), flush=True)

    board.sort(key=lambda r: -r["test_macro_f1"])
    print("\nLeaderboard:")
    for r in board:
        print(f"  {r['tag']:>18} seed{r['seed']}: F1 {r['test_macro_f1']} "
              f"acc {r['test_acc']}% @ ep{r['best_epoch']}")
    return board


if __name__ == "__main__":
    main()
