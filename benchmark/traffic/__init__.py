"""Traffic generators.  ``workloads/<cell>.json`` names one by ``generator``;
its ``make(params, model, seed, device)`` returns a :class:`Traffic` made
from the seed alone.

A :class:`Traffic` carries its own schedule.  Without arrivals every call is
closed loop: the next call starts when the previous one has returned, as the
extraction CLI and the engine's lock do.  A workload file that sets
``rate_per_s`` asks for an open loop: the calls of a period arrive at that
mean rate (:func:`arrivals`), and a call that arrives while another runs
waits for it, as requests queue on the engine's lock.  A seed changes the
content of the items and the order of the calls and of the gaps between
arrivals, never their sets, so that two seeds ask for the same work.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, List, Optional, Sequence

import numpy as np


@dataclass
class Traffic:
    """``items``: the distinct inputs (indexable by item id), which the
    reference embeds once each.  ``calls``: one period of the cell's calls,
    each ``(item ids, argument of the entry)``; the window repeats the period
    in order.  ``offsets``: where set, each call's arrival in seconds from
    its period's start, and ``period_s`` the period's length; None for a
    closed loop."""

    items: Any
    calls: List[tuple]
    offsets: Optional[Sequence[float]] = None
    period_s: float = 0.0

    def arrival(self, i: int) -> Optional[float]:
        """Seconds from the first period's start to the arrival of the
        ``i``-th call of the repeated period; None for a closed loop."""
        if self.offsets is None:
            return None
        n = len(self.calls)
        return (i // n) * self.period_s + self.offsets[i % n]


def periods(sizes: Sequence[int], seed: int) -> list:
    """The call sizes of one period in the seed's order, each with the item
    ids it takes: consecutive runs of ``range(sum(sizes))``."""
    order = np.random.default_rng(seed).permutation(len(sizes))
    out, start = [], 0
    for i in order:
        out.append(np.arange(start, start + sizes[i]))
        start += sizes[i]
    return out


def arrivals(params: dict, n: int, seed: int):
    """``(offsets, period_s)`` of ``n`` calls a period for a workload file's
    ``rate_per_s``, or ``(None, 0.0)`` for a closed loop.  The gaps between
    arrivals are the ``n`` midpoint quantiles of an exponential of that mean
    rate (Poisson arrivals, stratified) in the seed's order."""
    rate = params.get("rate_per_s")
    if rate is None:
        return None, 0.0
    gaps = -np.log1p(-(np.arange(n) + 0.5) / n) / rate
    gaps = gaps[np.random.default_rng(seed + 1).permutation(n)]
    starts = np.concatenate([[0.0], np.cumsum(gaps)[:-1]])
    return [float(s) for s in starts], float(gaps.sum())
