"""End-to-end metric readers, one file a metric of ``BENCHMARK.json``'s
``end_to_end``, named after it and loaded by path (``spec.module``).  Each
has ``read(window)``, which returns the metric's value from a measured
window (:class:`benchmark.cell.Window`: the set-up time, the window's length
and every call's arrival, start, return and useful work, all on the host's
clock), or None where the window holds nothing it reads."""

from __future__ import annotations


def useful_rate(window):
    """All the useful work of the window's calls over the whole window."""
    if not window.calls or window.seconds <= 0:
        return None
    return sum(c.useful for c in window.calls) / window.seconds
