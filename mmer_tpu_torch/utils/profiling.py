"""Tracing, the port of ``mmer_tpu/utils/profiling.py``, and the program's
spans and counters.

- :func:`trace` wraps ``torch.profiler`` (CPU activity, and CUDA activity
  when a GPU is present) around any region and writes a Chrome trace into the
  directory, viewable in Perfetto or ``chrome://tracing``
  (``python3 -m mmer_tpu_torch.train.cli --profile_dir DIR`` profiles the
  run);
- :func:`span`, :func:`count` and :func:`cast` mark the program's stages and
  count its work.  They record only while a ``torch.profiler`` records
  (:func:`trace`, ``scripts/profile_*.py``, a benchmark's traced run): a
  span is then a ``record_function`` range on the profiler's clock, beside
  the device's kernels and copies, and adds its seconds to :data:`counters`
  under its own name; a counter adds to :data:`counters`.  Otherwise each
  costs one check of whether a profiler records.

Spans: ``mmer.vivit.{stage,upload,forward,fetch}`` a block of
``VideoFeatureExtractor.embed_chunks``;
``mmer.w2v2.{normalise,pad,upload,forward,fetch,merge}`` a call of
``AudioEmbedder.embed_batch``; ``mmer.wavlm.rel_bias`` a WavLM forward,
around building its relative position vector; ``mmer.serve.<stage>`` in
``InferenceEngine.infer_frames``.  Counters: ``w2v2.frames_useful`` and
``w2v2.frames_computed`` (the real pieces' frames, and every row run times
its frames, in ``AudioEmbedder._embed_padded``), ``weights.cast_bytes``
(bytes read plus written by :func:`cast` of a parameter to another dtype),
``wavlm.bias_bytes`` (bytes of the position-bias tensors a WavLM forward
writes: the (H, 2T - 1) relative vector once, each layer's (B, H, T)
gate; the gated term is added to the scores inside the attention kernel,
or in place from the (H, T, T) table a torch route expands, uncounted)
and each span's seconds under its name.
"""

from __future__ import annotations

import contextlib
import os
import time
from typing import Dict, Iterator, Optional

import torch

# Whether a torch.profiler is recording: true between the start and the
# stop of a profile's active steps, false in its wait and warm-up steps.
recording = torch._C._autograd._profiler_enabled

# Totals of the program's counters, added to while a profiler records and
# never reset: a reader takes the difference across its window.
counters: Dict[str, float] = {}


@contextlib.contextmanager
def trace(log_dir: Optional[str]) -> Iterator[None]:
    """torch.profiler trace context writing ``<log_dir>/trace_<pid>_<ts>.json``
    (Chrome trace format); a no-op when ``log_dir`` is None."""
    if not log_dir:
        yield
        return
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with profile(activities=activities) as prof:
        yield
    prof.export_chrome_trace(os.path.join(
        log_dir, f"trace_{os.getpid()}_{time.strftime('%Y%m%d_%H%M%S')}.json"))


class span:
    """``with span("mmer.w2v2.pad"):`` marks a stage of the program.  While
    a profiler records it is a ``torch.profiler.record_function`` range of
    that name, and its seconds are added to ``counters[name]``; otherwise
    it records nothing.  With ``into`` (a dict), its seconds are also added
    to ``into[<the name's last part>]``, profiler or not."""

    __slots__ = ("name", "into", "_range", "_t0")

    def __init__(self, name: str, into: Optional[Dict[str, float]] = None):
        self.name = name
        self.into = into

    def __enter__(self) -> "span":
        self._range = None
        if recording():
            self._range = torch.profiler.record_function(self.name)
            self._range.__enter__()
        if self._range is not None or self.into is not None:
            self._t0 = time.perf_counter()
        return self

    def __exit__(self, *exc) -> None:
        if self._range is None and self.into is None:
            return
        seconds = time.perf_counter() - self._t0
        if self.into is not None:
            self.into[self.name.rsplit(".", 1)[-1]] += seconds
        if self._range is not None:
            self._range.__exit__(*exc)
            counters[self.name] = counters.get(self.name, 0) + seconds


def count(name: str, n: float) -> None:
    """Add ``n`` to ``counters[name]`` while a profiler records."""
    if recording():
        counters[name] = counters.get(name, 0) + n


def cast(t: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """``t.to(dtype)`` for a parameter (or a view of one); while a profiler
    records, the bytes it reads and writes are added to
    ``counters["weights.cast_bytes"]`` (0 where the dtype is ``t``'s)."""
    if recording():
        moved = 0 if t.dtype == dtype else t.numel() * (t.element_size()
                                                         + dtype.itemsize)
        count("weights.cast_bytes", moved)
    return t.to(dtype)
