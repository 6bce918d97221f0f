"""Feature-artifact sanity checker (the reference's test.py:6-33).

Prints shapes/dtypes of the first N video/audio pairs and the dataset-wide
max chunk count; exits non-zero when any artifact violates the contract.

Run: ``python3 -m mmer_tpu_torch.data.check [--video_dir D] [--audio_dir D] [-n 10]``
"""

from __future__ import annotations

import argparse
import sys

from mmer_tpu_torch.config import DataConfig
from mmer_tpu_torch.core.artifacts import (ArtifactError,
                                           load_audio_features,
                                           load_video_features)
from mmer_tpu_torch.data.catalog import build_catalog


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description="Check feature artifacts")
    p.add_argument("--video_dir", default=DataConfig.video_feat_dir)
    p.add_argument("--audio_dir", default=DataConfig.audio_feat_dir)
    p.add_argument("-n", "--num_show", type=int, default=10)
    args = p.parse_args(argv)

    catalog = build_catalog(args.video_dir, args.audio_dir, pairing="key")
    print(f"{len(catalog)} paired samples")
    bad = 0
    max_chunks = 0
    for i, entry in enumerate(catalog):
        try:
            v = load_video_features(entry.video_path)
            a = load_audio_features(entry.audio_path)
        except ArtifactError as e:
            print(f"BAD {entry.key}: {e}")
            bad += 1
            continue
        max_chunks = max(max_chunks, v.shape[0])
        if i < args.num_show:
            print(f"{entry.key}: video {v.shape} {v.dtype}, "
                  f"audio {a.shape} {a.dtype}, label {entry.label}")
    print(f"max chunks (T): {max_chunks}")
    if bad:
        print(f"{bad} bad artifacts")
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
