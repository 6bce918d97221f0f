"""Faults planted under a cell's timed path, to show that its check fails
them: each a hook ``hook(program, state)`` for :func:`benchmark.cell.run`,
which breaks the built entry where it produces its rows or where it reads
its inputs.  ``benchmark/tests/test_bench_faults.py`` runs them on the CPU
at tiny widths; ``python3 -m benchmark.control --faults ...`` reads them on
the card at a cell's own sizes.
"""

from __future__ import annotations

import torch


def half_mean(rows: torch.Tensor) -> torch.Tensor:
    """Half of the batch left out: the first half of the rows kept, the
    rest replaced by their mean."""
    keep = (rows.shape[0] + 1) // 2
    out = rows.clone()
    out[keep:] = rows[:keep].mean(0)
    return out


def altered(rows: torch.Tensor) -> torch.Tensor:
    """The first row's answer (never a padding row) moved by 1 % of its
    norm, along one feature."""
    out = rows.clone()
    out[0, 0] += 0.01 * rows[0].norm()
    return out


def rolled(rows: torch.Tensor) -> torch.Tensor:
    """Each row's answer returned for the next row's item (pieces of one
    clip are neighbours, so a swap of two would not change the clip)."""
    return torch.roll(rows, 1, 0)


def tubelets_reversed(video: torch.Tensor) -> torch.Tensor:
    """(B, F, H, W, C) frames → the same tubelets with their order in time
    reversed (4 frames a tubelet), as a wrong token layout would give."""
    b, f = video.shape[:2]
    return video.reshape(b, f // 4, 4, *video.shape[2:]).flip(1).reshape(video.shape)


def tubelet_flattened_channel_first(video: torch.Tensor) -> torch.Tensor:
    """(B, F, H, W, C) frames → frames whose 4 x 16 x 16 x C tubelets hold
    their pixels in (C, t, ph, pw) order where the projection reads (t, ph,
    pw, C): a flatten in the wrong order."""
    b, f, h, w, c = video.shape
    x = video.reshape(b, f // 4, 4, h // 16, 16, w // 16, 16, c)
    x = x.permute(0, 1, 3, 5, 2, 4, 6, 7).reshape(b, f // 4, h // 16, w // 16, -1)
    x = x.reshape(*x.shape[:4], -1, c).transpose(-1, -2)
    x = x.reshape(b, f // 4, h // 16, w // 16, 4, 16, 16, c)
    return x.permute(0, 1, 4, 2, 5, 3, 6, 7).reshape(video.shape)


def scaled_256(video: torch.Tensor) -> torch.Tensor:
    """Pixels scaled by 1/256 where the model takes 1/255."""
    return video * (255.0 / 256.0)


OUTPUT = {"half_batch": half_mean, "altered": altered, "misrouted": rolled}
INPUT = {"tubelets_reversed": tubelets_reversed,
         "tubelet_flattened_channel_first": tubelet_flattened_channel_first,
         "scaled_256": scaled_256}


def plant(name: str):
    """The hook that plants fault ``name`` of :data:`OUTPUT` (on the rows of
    the forward whose rows the entry returns) or :data:`INPUT` (on a ViViT's
    frames as its model takes them, in [0, 1])."""
    fault = OUTPUT.get(name) or INPUT[name]

    def hook(program, state):
        target = program.target
        if hasattr(target, "embed_rows"):              # AudioEmbedder
            if name in INPUT:
                raise ValueError(f"{name} is a fault of a ViViT's input")
            inner = target.embed_rows
            target.embed_rows = lambda waves, mask: fault(inner(waves, mask))
        else:                                          # VideoFeatureExtractor
            forward = target.model.forward
            if name in INPUT:
                target.model.forward = lambda x: forward(fault(x))
            else:
                target.model.forward = lambda x: fault(forward(x))
    return hook
