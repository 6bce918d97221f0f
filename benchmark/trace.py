"""The traced sub-window: torch.profiler over CUPTI, reduced to what the
per-layer readers need.

The harness wraps each call of the window in its own host spans
(``bench.stage``: picking the call's inputs, ``bench.call``: the entry,
``bench.collect``: keeping its rows) inside one ``bench.window`` span that
ends after a device synchronise.  From the trace it keeps every device
operation (kernels, copies, sets) that ran inside that span, the device's
busy time (the union of their intervals), and the host's spans and
operations, which name each idle gap by what the host was doing halfway
through it.
"""

from __future__ import annotations

import re
from dataclasses import dataclass, field
from typing import List, Optional

SPANS = ("bench.stage", "bench.call", "bench.collect")
WINDOW = "bench.window"


def base_name(name: str) -> str:
    """A kernel's function name without its return type, namespace,
    template arguments or parameters: ``void ffn_kernel<__nv_bfloat16>(...)``
    → ``ffn_kernel``."""
    n = name[5:] if name.startswith("void ") else name
    n = n.replace("(anonymous namespace)::", "")
    return re.split(r"[<(]", n, maxsplit=1)[0].rsplit("::", 1)[-1].strip()


def kind_of(name: str) -> str:
    if name.startswith("Memcpy HtoD"):
        return "h2d"
    if name.startswith("Memcpy DtoH"):
        return "d2h"
    if name.startswith("Memcpy"):
        return "copy"
    if name.startswith("Memset"):
        return "set"
    return "kernel"


@dataclass
class DeviceOp:
    name: str
    start: float          # microseconds on the trace's clock
    dur: float
    kind: str

    @property
    def base(self) -> str:
        return base_name(self.name)


@dataclass
class Trace:
    """One traced sub-window.  ``useful`` and ``flops``: the useful work of
    its calls (the system's unit, and the model operations it needs);
    ``forwards``: the device forwards its calls imply."""

    window_s: float
    busy_s: float
    ops: List[DeviceOp]
    gaps: list                      # [(label, seconds)] of the longest idle gaps
    config: dict
    useful: float = 0.0
    flops: float = 0.0
    calls: int = 0
    forwards: list = field(default_factory=list)

    def of(self, *names: str) -> List[DeviceOp]:
        """The kernels whose base name is one of ``names``."""
        return [o for o in self.ops if o.kind == "kernel" and o.base in names]

    def seconds(self, ops) -> float:
        return sum(o.dur for o in ops) / 1e6


def _union(intervals) -> list:
    merged: list = []
    for s, e in sorted(intervals):
        if merged and s <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], e)
        else:
            merged.append([s, e])
    return merged


def _label(t: float, spans: list, host_ops: list) -> str:
    """What the host was doing at ``t`` (a gap's midpoint): the benchmark's
    span and the innermost host operation open then; the span alone where
    the host ran code outside any operation (numpy, Python)."""
    span = next((n for n, s, e in spans if s <= t < e), "between calls")
    inner = None
    for name, s, e in host_ops:
        if s > t:
            break
        if e > t:
            inner = name
    return span.replace("bench.", "") + (f"/{inner}" if inner else "")


def read(prof, config: dict, top_gaps: int = 10) -> Trace:
    """The :class:`Trace` of a finished ``torch.profiler.profile`` whose
    active step held one ``bench.window`` span."""
    from torch.autograd import DeviceType

    events = prof.events()
    window = next(e for e in events if e.name == WINDOW)
    w0, w1 = window.time_range.start, window.time_range.end
    ops, spans, host = [], [], []
    for e in events:
        s, end = e.time_range.start, e.time_range.end
        if e.device_type == DeviceType.CUDA:
            if getattr(e, "is_user_annotation", False) or not w0 <= s < w1:
                continue
            ops.append(DeviceOp(e.name, s, end - s, kind_of(e.name)))
        elif e.name in SPANS:
            spans.append((e.name, s, end))
        elif e.name != WINDOW and w0 <= s < w1:
            host.append((e.name, s, end))
    host.sort(key=lambda x: x[1])
    busy = _union((o.start, min(o.start + o.dur, w1)) for o in ops)
    edges = [w0] + [x for iv in busy for x in iv] + [w1]
    gaps = [(edges[i], edges[i + 1]) for i in range(0, len(edges), 2)
            if edges[i + 1] > edges[i]]
    longest = sorted(gaps, key=lambda g: g[0] - g[1])[:top_gaps]
    return Trace(window_s=(w1 - w0) / 1e6,
                 busy_s=sum(e - s for s, e in busy) / 1e6, ops=ops,
                 gaps=[(_label((s + e) / 2, spans, host), (e - s) / 1e6)
                       for s, e in longest],
                 config=config)


def device_ops(trace: Trace, top: int = 10) -> list:
    """``[[name, seconds], ...]``: the device operations that took most
    time, summed by name."""
    total: dict = {}
    for o in trace.ops:
        total[o.name] = total.get(o.name, 0.0) + o.dur / 1e6
    return [[n[:160], s] for n, s in sorted(total.items(), key=lambda x: -x[1])[:top]]


def roofline(trace: Trace, names: tuple, main: str, expected: int,
             bound: float) -> Optional[float]:
    """``bound`` seconds over the device time of the launches of ``names``,
    as a percentage.  Where the profiler dropped launches of ``main`` (fewer
    seen than the ``expected`` the shapes imply), the time seen is scaled
    up by expected / seen, so that a dropped launch reads as an average one.
    None where no launch of ``main`` was seen."""
    seen = len(trace.of(main))
    if not seen or not expected:
        return None
    time = trace.seconds(trace.of(*names)) * max(1.0, expected / seen)
    return 100.0 * bound / time
