"""Quality sensitivity of the fusion model to noise in its input features,
the port of ``scripts/probe_feature_noise_quality.py``.

    python3 -m mmer_tpu_torch.scripts.probe_feature_noise_quality \\
        --video_feat_dir DIR --audio_feat_dir DIR [--levels 0,0.01,0.02,0.05] \\
        [--seeds 2] [--epochs 400] [--modality both|video|audio]

Noise of a relative L2 size ``rel`` is added to every sample's features
before the dataset's normalisation, where an extractor's numerical error
would enter (per sample ``f <- f + rel * ||f|| * g / ||g||``, ``g`` unit
normal, drawn once a level from a fixed seed, so train, validation and test
see one realisation); then the winning recipe is retrained for ``--seeds``
seeds through ``train/fused.train_many_seeds``.  Prints a line a level and
the summary (each seed's best-epoch and validation-selected test macro-F1)
as JSON, and returns the summary.  Trains on the GPU (``--device cpu`` for a
rehearsal).
"""

from __future__ import annotations

import argparse
import json

import numpy as np

from mmer_tpu_torch.scripts.quality import (add_data_args, best_f1,
                                            data_config, scratch_dir,
                                            val_selected_f1)


def _noised(arrs, rel: float, rng) -> list:
    if rel <= 0:
        return arrs
    out = []
    for a in arrs:
        g = rng.standard_normal(a.shape).astype(a.dtype)
        gn = float((g ** 2).sum()) ** 0.5
        an = float((a ** 2).sum()) ** 0.5
        out.append(a + (rel * an / max(gn, 1e-12)) * g)
    return out


def main(argv=None) -> dict:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--levels", default="0,0.01,0.02,0.05",
                        help="comma-separated relative-L2 noise levels")
    parser.add_argument("--seeds", type=int, default=2)
    parser.add_argument("--epochs", type=int, default=400)
    parser.add_argument("--epochs_per_call", type=int, default=100)
    parser.add_argument("--modality", choices=("both", "video", "audio"),
                        default="both",
                        help="which modality receives the noise")
    add_data_args(parser)
    args = parser.parse_args(argv)
    levels = [float(x) for x in args.levels.split(",")]

    from mmer_tpu_torch.config import ModelConfig, TrainConfig
    from mmer_tpu_torch.data import catalog as catalog_mod
    from mmer_tpu_torch.data import pipeline
    from mmer_tpu_torch.scripts.timing import resolve_device
    from mmer_tpu_torch.train.fused import train_many_seeds

    device = resolve_device(args.device)
    cfg = data_config(args)
    catalog = catalog_mod.build_catalog(cfg.video_feat_dir, cfg.audio_feat_dir,
                                        cfg.pairing)
    videos0, audios0 = pipeline.load_feature_arrays(catalog)
    labels = np.asarray([e.label for e in catalog], dtype=np.int32)

    summary = {"modality": args.modality}
    for rel in levels:
        nrng = np.random.default_rng(1234)
        rel_v = rel if args.modality in ("both", "video") else 0.0
        rel_a = rel if args.modality in ("both", "audio") else 0.0
        videos = _noised(videos0, rel_v, nrng)
        audios = np.stack(_noised(list(audios0), rel_a, nrng)) \
            if rel_a > 0 else audios0
        data, splits = pipeline.dataset_from_features(
            videos, audios, labels, [e.key for e in catalog], cfg)

        model_cfg = ModelConfig(max_seq_len=data.max_chunks + 1,
                                fusion_dropout=0.2, classifier_dropout=0.2)
        train_cfg = TrainConfig(num_epochs=args.epochs, lr=1e-5,
                                weight_decay=5e-3, label_smoothing=0.1,
                                save_checkpoints=False,
                                output_dir=scratch_dir("noise_probe"))
        outs = train_many_seeds(data, splits, model_cfg, train_cfg,
                                batch_size=64, seeds=list(range(args.seeds)),
                                seeds_per_call=min(args.seeds, 4),
                                epochs_per_call=args.epochs_per_call,
                                device=device)
        best, sel = best_f1(outs), val_selected_f1(outs)
        summary[rel] = {"best_epoch_f1": [round(b, 4) for b in best],
                        "val_selected_f1": [round(s, 4) for s in sel]}
        print(f"rel={rel}: best-epoch F1 {np.mean(best):.4f}"
              f"+/-{np.std(best):.4f}  val-selected {np.mean(sel):.4f}"
              f"+/-{np.std(sel):.4f}", flush=True)

    print(json.dumps(summary))
    return summary


if __name__ == "__main__":
    main()
