"""Tracing and step-time observability, the port of
``mmer_tpu/utils/profiling.py``.

- :func:`trace` wraps ``torch.profiler`` (CPU activity, and CUDA activity
  when a GPU is present) around any region and writes a Chrome trace into the
  directory, viewable in Perfetto or ``chrome://tracing``
  (``python3 -m mmer_tpu_torch.train.cli --profile_dir DIR`` profiles the
  run);
- :class:`StepTimer` records wall times of named phases and summarises
  p50 / p90 / max.
"""

from __future__ import annotations

import contextlib
import json
import os
import time
from collections import defaultdict
from typing import Dict, Iterator, List, Optional


@contextlib.contextmanager
def trace(log_dir: Optional[str]) -> Iterator[None]:
    """torch.profiler trace context writing ``<log_dir>/trace_<pid>_<ts>.json``
    (Chrome trace format); a no-op when ``log_dir`` is None."""
    if not log_dir:
        yield
        return
    import torch
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with profile(activities=activities) as prof:
        yield
    prof.export_chrome_trace(os.path.join(
        log_dir, f"trace_{os.getpid()}_{time.strftime('%Y%m%d_%H%M%S')}.json"))


class StepTimer:
    """Wall-clock phase timer with percentile summaries."""

    def __init__(self) -> None:
        self._times: Dict[str, List[float]] = defaultdict(list)

    @contextlib.contextmanager
    def phase(self, name: str) -> Iterator[None]:
        t0 = time.perf_counter()
        try:
            yield
        finally:
            self._times[name].append(time.perf_counter() - t0)

    def record(self, name: str, seconds: float) -> None:
        self._times[name].append(seconds)

    def summary(self) -> Dict[str, Dict[str, float]]:
        out: Dict[str, Dict[str, float]] = {}
        for name, ts in self._times.items():
            ts_sorted = sorted(ts)
            n = len(ts_sorted)
            out[name] = {
                "count": n,
                "mean_s": sum(ts_sorted) / n,
                "p50_s": ts_sorted[n // 2],
                "p90_s": ts_sorted[min(n - 1, int(n * 0.9))],
                "max_s": ts_sorted[-1],
                "total_s": sum(ts_sorted),
            }
        return out

    def dump(self, path: str) -> None:
        with open(path, "w") as f:
            json.dump(self.summary(), f, indent=2)
