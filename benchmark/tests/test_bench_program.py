"""The readers of the program's own spans and counters (``benchmark/program.py``,
``host_ms.w2v2``, ``useful_share.w2v2``, ``cast_mb.*``): their arithmetic,
a traced tiny run that reports them, a program without the tracer that
still runs and reports none of them, and traces whose program spans change
no reader that was there and name the idle gaps they hold."""

from __future__ import annotations

from types import SimpleNamespace

import pytest
from torch.autograd import DeviceType

from benchmark import spec, trace as tracing, work
from benchmark.tests.conftest import cpu_run, tiny_cell
from benchmark.trace import Trace
from mmer_tpu_torch.utils import profiling

NEW = ("host_ms.w2v2", "useful_share.w2v2", "cast_mb.vivit", "cast_mb.w2v2")


@pytest.fixture
def fresh(monkeypatch):
    """The program's totals, empty: as in a benchmark process, whose traced
    window is the only one that records."""
    totals: dict = {}
    monkeypatch.setattr(profiling, "counters", totals)
    return totals


def _read(name: str, t: Trace):
    return spec.module("metrics", name).read(t)


def _trace(useful: float) -> Trace:
    return Trace(window_s=1.0, busy_s=0.5, ops=[], gaps=[], config={}, useful=useful)


def test_readers_arithmetic(fresh):
    fresh.update({"mmer.w2v2.normalise": 0.030, "mmer.w2v2.pad": 0.010,
                  "mmer.w2v2.merge": 0.002, "mmer.w2v2.forward": 5.0,
                  "w2v2.frames_useful": 10192, "w2v2.frames_computed": 15936,
                  "weights.cast_bytes": 2e9})
    t = _trace(useful=400.0)
    assert _read("host_ms.w2v2", t) == pytest.approx(1e3 * 0.042 / 400)
    assert _read("useful_share.w2v2", t) == pytest.approx(63.955823, abs=1e-6)
    assert _read("cast_mb.vivit", t) == pytest.approx(5.0)
    assert _read("cast_mb.w2v2", t) == pytest.approx(5.0)


def test_readers_find_nothing_without_counters(fresh, monkeypatch):
    t = _trace(useful=400.0)
    assert all(_read(name, t) is None for name in NEW)
    monkeypatch.delattr(profiling, "counters")
    assert all(_read(name, t) is None for name in NEW)


def test_traced_run_reports_the_programs_counts(fresh):
    """The tiny Wav2Vec2 cell in bf16: ``useful_share.w2v2`` is the share
    of the real pieces' frames in the rows the window's forwards ran."""
    c = tiny_cell("w2v2-large.extract", dtype="bfloat16", limit=0.05)
    run = cpu_run(c, traced=True)
    m = c.config["model"]
    useful = sum(work.w2v2_frames(m, p) for f in run.trace.forwards for p in f["pieces"])
    computed = sum(f["rows"] * f["frames"] for f in run.trace.forwards)
    assert useful < computed
    assert run.metrics["useful_share.w2v2"] == pytest.approx(100.0 * useful / computed)
    assert run.metrics["host_ms.w2v2"] > 0
    assert run.metrics["cast_mb.w2v2"] > 0
    assert "cast_mb.vivit" not in run.metrics
    assert {"mfu.w2v2", "idle_share.w2v2"} <= set(run.metrics)


def test_a_program_without_the_tracer_runs_and_reports_none_of_them(monkeypatch):
    """As the parent of the tracer: no ``counters``, and nothing records."""
    monkeypatch.delattr(profiling, "counters")
    monkeypatch.setattr(profiling, "recording", lambda: False)
    for name in ("vivit-b.extract", "w2v2-large.extract"):
        run = cpu_run(tiny_cell(name), traced=True)
        assert not set(NEW) & set(run.metrics), name
        assert any(k.startswith("idle_share.") for k in run.metrics)


def _event(name, start, end, device=DeviceType.CPU):
    return SimpleNamespace(name=name, device_type=device, is_user_annotation=False,
                           time_range=SimpleNamespace(start=start, end=end))


def _profile(program_spans: bool):
    """A traced window of 0-1,000 us: one call whose device work has a gap
    at 300-500 us, where the host ran numpy inside ``mmer.w2v2.pad``."""
    events = [_event(tracing.WINDOW, 0.0, 1000.0), _event("bench.call", 10.0, 990.0),
              _event("aten::copy_", 100.0, 140.0), _event("cudaLaunchKernel", 520.0, 530.0),
              _event("Memcpy HtoD (Pageable -> Device)", 20.0, 300.0, DeviceType.CUDA),
              _event("void ffn_kernel<float>()", 500.0, 980.0, DeviceType.CUDA)]
    if program_spans:
        events += [_event("mmer.w2v2.normalise", 15.0, 90.0),
                   _event("mmer.w2v2.pad", 90.0, 510.0),
                   _event("mmer.w2v2.forward", 515.0, 600.0)]
    return SimpleNamespace(events=lambda: events)


def test_program_spans_change_no_reader_that_was_there_and_name_the_gap():
    cell = spec.cell(spec.load(), "w2v2-large.extract")
    plain, marked = (tracing.read(_profile(p), cell.config) for p in (False, True))
    for t in (plain, marked):
        t.useful, t.flops, t.calls = 10.0, 1e12, 1
    for m in cell.per_layer:
        if m["name"] not in NEW:
            assert _read(m["name"], plain) == _read(m["name"], marked), m["name"]
    assert (plain.window_s, plain.busy_s) == (marked.window_s, marked.busy_s)
    assert plain.gaps[0] == ("call", pytest.approx(200e-6))
    assert marked.gaps[0] == ("call/mmer.w2v2.pad", pytest.approx(200e-6))
