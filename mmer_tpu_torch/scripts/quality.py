"""What the quality scripts (``sweep``, ``quality_sweep``, ``probe_*``)
share: the feature folders and the device on the command line, the dataset,
and their scratch directories."""

from __future__ import annotations

import argparse
import os
import tempfile

from mmer_tpu_torch.config import DataConfig


def add_data_args(parser: argparse.ArgumentParser) -> None:
    parser.add_argument("--video_feat_dir", default=DataConfig.video_feat_dir)
    parser.add_argument("--audio_feat_dir", default=DataConfig.audio_feat_dir)
    parser.add_argument("--device", default="cuda",
                        help="cuda (default; raises without a GPU) or cpu")


def data_config(args) -> DataConfig:
    return DataConfig(video_feat_dir=args.video_feat_dir,
                      audio_feat_dir=args.audio_feat_dir)


def load(args):
    """(device, data, splits) of the parsed arguments: the device checked
    first, then ``load_dataset`` of the two folders."""
    from mmer_tpu_torch.data import pipeline
    from mmer_tpu_torch.scripts.timing import resolve_device

    device = resolve_device(args.device)
    data, splits = pipeline.load_dataset(data_config(args))
    return device, data, splits


def scratch_dir(name: str) -> str:
    """A quality script's output directory under the temporary directory (the JAX
    scripts' ``/tmp/<name>``)."""
    return os.path.join(tempfile.gettempdir(), name)


def best_f1(outs) -> list:
    """Each seed's best-epoch test macro-F1."""
    return [max(o["results"], key=lambda r: r["test_macro_f1"])["test_macro_f1"]
            for o in outs]


def val_selected_f1(outs) -> list:
    """Each seed's test macro-F1 at its lowest validation loss."""
    return [min(o["results"], key=lambda r: r["val_loss"])["test_macro_f1"]
            for o in outs]
