"""One run of one cell: set-up, the measured (or traced) window, the check.

Set-up makes the weights on the device from the seed, the traffic from the
seed, builds the port's entry from them, and runs every distinct call of the
traffic's period once, so that every kernel is built and every shape has run
before the window.  The window then repeats the period on the traffic's own
schedule (closed loop, or arrivals at a rate) for ``seconds``: a closed
loop's last call started inside it is finished and counted, an open loop
makes every call that arrives inside it.  Each end-to-end metric is read
from the window's record by its own file, ``end_to_end/<metric>.py``.  Once
the window has closed and the device's peak memory is read, the program is
freed and the plain float32 reference embeds every distinct item; every row
the window returned is compared with its item's reference.
"""

from __future__ import annotations

import contextlib
import gc
import sys
import time
from dataclasses import dataclass, field
from typing import Callable, Optional

import numpy as np
import torch

from benchmark import spec, trace as tracing, weights


@dataclass
class Call:
    """One call of a window: its index in the traffic's period, and its
    arrival, start and return in seconds from the window's start (a closed
    loop's call arrives when it starts), with the useful work it returned."""

    index: int
    arrival: float
    start: float
    end: float
    useful: float = 0.0


@dataclass
class Window:
    """What the end-to-end readers read: the set-up's seconds, the window's
    seconds (its start to the later of its end and the last return) and
    its calls."""

    setup_s: float
    seconds: float
    calls: list


@dataclass
class Run:
    """What one run measured and checked."""

    setup_s: float
    window_s: float
    calls: int
    useful: float
    metrics: dict                       # name → value, in BENCHMARK.json's units
    check: dict                         # name → (value, limit)
    attempted: int
    failed: int
    memory_peak_bytes: int
    info: list = field(default_factory=list)    # lines for standard error
    summary: dict = field(default_factory=dict)     # the row errors' spread
    trace: Optional[tracing.Trace] = None


def modules(cell: spec.Cell):
    """The cell's system, reference and traffic generator, found by name in
    the checkout it was read from."""
    kind = cell.config["kind"]
    return (spec.module("systems", kind, cell.root),
            spec.module("reference", kind, cell.root),
            spec.module("traffic", cell.traffic["generator"], cell.root))


def _span(name: str, on: bool):
    return torch.profiler.record_function(name) if on else contextlib.nullcontext()


def _drive(program, traffic, first: int, outputs: list, spans: bool,
           count: Optional[int] = None, seconds: Optional[float] = None) -> list:
    """Calls of the period from index ``first`` on, on the traffic's
    schedule: ``count`` of them, or those of a window of ``seconds`` (a
    closed loop's calls until one returns after it, an open loop's calls
    that arrive before it).  Each call's rows are kept in ``outputs`` with
    its index in the period; returns its :class:`Call` records."""
    n, made, i = len(traffic.calls), [], first
    base = traffic.arrival(first)
    t0 = time.perf_counter()
    while True:
        due = traffic.arrival(i)
        if due is not None:
            due -= base
            if count is None and due >= seconds:
                break
            wait = t0 + due - time.perf_counter()
            if wait > 0:
                time.sleep(wait)
        start = time.perf_counter() - t0
        with _span("bench.stage", spans):
            c = i % n
            arg = traffic.calls[c][1]
        with _span("bench.call", spans):
            out = program.call(arg)
        with _span("bench.collect", spans):
            outputs.append((c, out))
        end = time.perf_counter() - t0
        made.append(Call(c, start if due is None else due, start, end))
        i += 1
        if count is not None and len(made) >= count:
            break
        if count is None and due is None and end >= seconds:
            break
    return made


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def run(cell: spec.Cell, seed: int, seconds: float, traced: bool,
        device: torch.device, started: float,
        hook: Optional[Callable] = None) -> Run:
    """One run of ``cell``; ``started`` is the host clock at the process's
    start (set-up counts from it); ``hook(program, state)``, where given,
    changes the program after it is built from the seeded ``state`` (a
    control, or a planted fault: ``benchmark.control``, ``benchmark.faults``)."""
    system, reference, generator = modules(cell)
    marks = [("imports", time.perf_counter())]
    m = cell.config["model"]
    shapes = reference.param_shapes(m)
    traffic = generator.make(cell.traffic, m, seed, device)
    if device.type == "cuda":
        torch.cuda.synchronize(device)
        torch.cuda.reset_peak_memory_stats(device)
    marks.append(("traffic", time.perf_counter()))
    state = weights.make_state(shapes, seed, device, weights.values_of(m))
    program = system.build(cell.config, cell.traffic, state, device)
    if hook is not None:
        hook(program, state)
    del state
    _sync(device)
    marks.append(("weights and build", time.perf_counter()))
    for _, arg in traffic.calls:
        program.call(arg)
    _sync(device)
    marks.append(("warm-up calls", time.perf_counter()))
    setup_s = time.perf_counter() - started
    phases = ", ".join(f"{name} {t - prev:.3f} s" for (name, t), (_, prev)
                       in zip(marks, [("start", started)] + marks))

    outputs: list = []
    trace = None
    if not traced:
        made = _drive(program, traffic, 0, outputs, False, seconds=seconds)
    else:
        from torch.profiler import ProfilerActivity, profile, schedule

        acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA]
                                         if device.type == "cuda" else [])
        # One call traced and dropped first: on an H100 the first kernels
        # after a trace starts were now and then missing from it.
        with profile(activities=acts, schedule=schedule(wait=0, warmup=1, active=1)) as prof:
            _drive(program, traffic, 0, [], False, count=1)
            _sync(device)
            prof.step()
            with torch.profiler.record_function(tracing.WINDOW):
                made = _drive(program, traffic, 1, outputs, True,
                              count=cell.traffic["trace_calls"])
                _sync(device)
        trace = tracing.read(prof, cell.config)
    memory_peak = (torch.cuda.max_memory_allocated(device)
                   if device.type == "cuda" else 0)
    del program
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()

    args = [traffic.calls[c][1] for c, _ in outputs]
    for call, arg in zip(made, args):
        call.useful = system.useful(arg, cell.config)
    window = Window(setup_s=setup_s, seconds=max(seconds if not traced else 0.0,
                                                 made[-1].end), calls=made)
    useful = sum(c.useful for c in made)
    result = Run(setup_s=setup_s, window_s=window.seconds, calls=len(made),
                 useful=useful, metrics={}, check={}, attempted=0, failed=0,
                 memory_peak_bytes=int(memory_peak), trace=trace,
                 info=[f"setup {setup_s:.3f} s: {phases}"])
    if trace is None:
        for metric in cell.end_to_end:
            value = spec.module("end_to_end", metric["name"], cell.root).read(window)
            if value is not None:
                result.metrics[metric["name"]] = value
        # How steady the window was: each period's seconds (a period holds
        # every call size once, so periods are alike work).
        n = len(traffic.calls)
        per = np.diff([0.0] + [c.end for c in made][n - 1::n])
        if len(per) >= 2:
            q = np.quantile(per, [0, 0.25, 0.5, 0.75, 1])
            result.info.append(f"{len(per)} whole periods of {n} calls, "
                               "seconds min / q1 / median / q3 / max: "
                               + " / ".join(f"{x:.4f}" for x in q))
    else:
        trace.useful, trace.calls = useful, len(made)
        trace.flops = sum(system.flops(a, cell.config) for a in args)
        trace.forwards = [f for a in args for f in system.forwards(a, cell.config,
                                                                   cell.traffic)]
        _per_layer(cell, trace, result)

    state = weights.make_state(shapes, seed, device, weights.values_of(m))
    want = reference.outputs(state, m, traffic.items, device).numpy()
    del state
    _compare(cell, traffic, outputs, want, result)
    return result


def _per_layer(cell: spec.Cell, trace: tracing.Trace, result: Run) -> None:
    """The cell's per-layer metrics from the trace, and the check of each
    hand-written kernel's launches against those the shapes imply."""
    for metric in cell.per_layer:
        reader = spec.module("metrics", metric["name"], cell.root)
        value = reader.read(trace)
        if value is not None:
            result.metrics[metric["name"]] = value
        if hasattr(reader, "launches"):
            for kernel, want in reader.launches(trace).items():
                seen = len(trace.of(kernel))
                line = f"launches {kernel}: {seen} seen, {want} implied by the shapes"
                if seen < want:
                    line += (f"; the profiler dropped {want - seen} of {want}"
                             " (the roofline scales the time seen)")
                elif seen > want:
                    line += "; MORE than the shapes imply"
                result.info.append(line)


def _compare(cell: spec.Cell, traffic, outputs: list, want: np.ndarray,
             result: Run) -> None:
    """Every returned row against its item's reference.  Compared, each
    against its limit (the workload file's ``limits``, or 0):

    - ``worst_rel_l2``: the largest ``|got - want| / |want|`` of a row;
    - ``bias_rel_l2``: ``|mean(got - want)| / mean|want|`` over all rows,
      the part of the error that every row shares (a lower precision, or
      a term left out, moves it; rounding that differs from row to row
      averages out of it);
    - ``misrouted_rows``: rows nearer another item's reference than their
      own (a row returned for the wrong item);
    - ``malformed_rows``: rows of the wrong shape or not finite.
    """
    limits = cell.traffic["limits"]
    ref = want.astype(np.float64)
    errs, diffs, norms, malformed, misrouted = [], [], [], 0, 0
    for c, rows in outputs:
        ids = traffic.calls[c][0]
        got = np.asarray(rows, np.float64)
        if got.shape != (len(ids), want.shape[1]) or not np.isfinite(got).all():
            malformed += len(ids)
            continue
        d = got - ref[ids]
        n = np.linalg.norm(ref[ids], axis=1)
        errs.append(np.linalg.norm(d, axis=1) / np.maximum(n, 1e-30))
        diffs.append(d.sum(0))
        norms.append(n.sum())
        dist = (np.square(got).sum(1)[:, None] - 2 * got @ ref.T
                + np.square(ref).sum(1)[None])
        misrouted += int((dist.argmin(1) != ids).sum())
    err = np.concatenate(errs) if errs else np.zeros(0)
    worst = float(err.max()) if err.size else float("inf")
    bias = (float(np.linalg.norm(np.sum(diffs, 0)) / np.sum(norms)) if err.size
            else float("inf"))
    result.attempted = int(err.size + malformed)
    result.failed = int((err > limits["worst_rel_l2"]).sum() + malformed + misrouted)
    result.check = {"worst_rel_l2": (worst, limits["worst_rel_l2"]),
                    "bias_rel_l2": (bias, limits["bias_rel_l2"]),
                    "misrouted_rows": (misrouted, 0), "malformed_rows": (malformed, 0)}
    # How far apart the items' references lie: a row returned for the wrong
    # item differs from its own reference by at least this much.
    gram = ref @ ref.T
    sq = np.diag(gram)
    spread = np.sqrt(np.maximum(sq[:, None] + sq[None] - 2 * gram, 0)) / np.sqrt(sq)[:, None]
    np.fill_diagonal(spread, np.inf)
    if err.size:
        result.summary = {"rows": int(err.size), "median": float(np.median(err)),
                          "p90": float(np.quantile(err, 0.9)), "worst": worst,
                          "bias": bias, "nearest_other": float(spread.min())}
        result.info.append("relative L2 of the rows: " + ", ".join(
            f"{k} {v:.6g}" for k, v in result.summary.items()))


def foreign_modules() -> list:
    """Modules of JAX, flax or the JAX package loaded in this process,
    compared by whole top-level name."""
    banned = {"jax", "jaxlib", "flax", "mmer_tpu"}
    return sorted(n for n in sys.modules if n.split(".")[0] in banned)
