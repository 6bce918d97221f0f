"""The control of each cell's check, on the card at the cell's own sizes:
the port with its int8 path switched on comes out not correct.  The cell's
limits were set below the control's readings (PERF.md §2); this holds them
there on one more seed.  Skips without a card.

    python3 -m pytest -o addopts= benchmark/tests/test_bench_control.py
"""

import time

import pytest

from benchmark import cell as cells, spec
from benchmark.control import control
from benchmark.run import CACHES, result_line

pytestmark = pytest.mark.cuda


@pytest.mark.parametrize("name", [w["name"] for w in spec.load()["workloads"]])
def test_int8_control_is_not_correct(name, cuda, monkeypatch):
    for key, path in CACHES.items():
        monkeypatch.setenv(key, str(path))
    c = spec.cell(spec.load(), name)
    run = cells.run(c, 2**31 + 97, 1.0, False, cuda, time.perf_counter(),
                    hook=control(c, "int8"))
    assert not result_line(run, c, {})["correct"], run.summary
