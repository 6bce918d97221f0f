"""Nothing the benchmark runs imports JAX, flax or the JAX package
(``mmer_tpu``), compared by whole top-level module name (so the port,
``mmer_tpu_torch``, passes), and the references import nothing of the port."""

import ast
import json
import subprocess
import sys
from pathlib import Path

from benchmark import spec
from benchmark.cell import foreign_modules

BANNED = {"jax", "jaxlib", "flax", "mmer_tpu"}
BENCH = spec.ROOT / "benchmark"


def imported_tops(path: Path) -> set:
    tree = ast.parse(path.read_text())
    names = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.module and not node.level:
            names.add(node.module.split(".")[0])
    return names


def test_no_source_imports_jax_or_the_jax_package():
    for path in BENCH.rglob("*.py"):
        assert not imported_tops(path) & BANNED, path


def test_references_import_nothing_of_the_port():
    for path in (BENCH / "reference").glob("*.py"):
        assert imported_tops(path) <= {"__future__", "contextlib", "math", "numpy",
                                       "torch", "benchmark"}, path


def test_whole_top_level_names_are_compared():
    sys.modules.setdefault("mmer_tpu_torch_lookalike", sys)
    assert "mmer_tpu_torch_lookalike" not in foreign_modules()


def test_a_run_loads_none_of_them():
    """A traced tiny run of every cell, every metric reader loaded, in a
    fresh interpreter: ``sys.modules`` holds none of the banned names."""
    code = (
        "import json, sys\n"
        "import benchmark.run, benchmark.control\n"
        "from benchmark import cell, spec\n"
        "from benchmark.tests.conftest import CELLS, cpu_run, tiny_cell\n"
        "for m in spec.load()['per_layer']: spec.module('metrics', m['name'])\n"
        "for name in CELLS: cpu_run(tiny_cell(name), traced=True)\n"
        "print(json.dumps(cell.foreign_modules()))\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=spec.ROOT, text=True,
                         capture_output=True, timeout=600)
    assert out.returncode == 0, out.stderr[-3000:]
    assert json.loads(out.stdout.strip().splitlines()[-1]) == []
