"""``BENCHMARK.json`` and the files it names, found by name.

A cell ``c`` of ``workloads`` reads ``benchmark/workloads/<c>.json`` (its
traffic); its ``config`` entry's ``file`` (the configuration); the
end-to-end metrics that list it, or list no cells, each read by
``benchmark/end_to_end/<name>.py``; and the per-layer metrics that list it,
or list no cells, each read by ``benchmark/metrics/<name>.py``.
Adding a cell, a configuration or a per-layer metric adds files and entries
and edits none.
"""

from __future__ import annotations

import importlib.util
import json
import re
from dataclasses import dataclass
from pathlib import Path
from types import ModuleType

ROOT = Path(__file__).resolve().parent.parent
NAME = re.compile(r"[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}")
UNIT = re.compile(r"[A-Za-z0-9_/%.\-]{1,16}")


@dataclass
class Cell:
    name: str
    chips: int
    config: dict          # the configuration file: kind, model, route, ...
    traffic: dict         # the workload file: generator and its parameters
    end_to_end: list      # BENCHMARK.json entries reported by this cell
    per_layer: list
    root: Path = ROOT     # the checkout whose files the cell was read from


def load(root: Path = ROOT) -> dict:
    with open(root / "BENCHMARK.json") as f:
        return json.load(f)


def _reports(metric: dict, cell: str) -> bool:
    return "workloads" not in metric or cell in metric["workloads"]


def cell(spec: dict, name: str, root: Path = ROOT) -> Cell:
    """The cell ``name`` of ``spec`` with its files read."""
    entry = next((w for w in spec["workloads"] if w["name"] == name), None)
    if entry is None:
        raise KeyError(f"no cell named {name!r} in BENCHMARK.json")
    conf = next(c for c in spec["configs"] if c["name"] == entry["config"])
    with open(root / conf["file"]) as f:
        config = json.load(f)
    with open(root / "benchmark" / "workloads" / f"{name}.json") as f:
        traffic = json.load(f)
    return Cell(name=name, chips=entry["chips"], config=config, traffic=traffic,
                end_to_end=[m for m in spec["end_to_end"] if _reports(m, name)],
                per_layer=[m for m in spec["per_layer"] if _reports(m, name)],
                root=root)


def module(folder: str, name: str, root: Path = ROOT) -> ModuleType:
    """``benchmark/<folder>/<name>.py`` of the checkout at ``root``, loaded
    by its path (names may hold ``.`` and ``-``)."""
    path = root / "benchmark" / folder / f"{name}.py"
    mod_spec = importlib.util.spec_from_file_location(
        f"benchmark.{folder}.{name.replace('.', '_').replace('-', '_')}", path)
    mod = importlib.util.module_from_spec(mod_spec)
    mod_spec.loader.exec_module(mod)
    return mod


def problems(spec: dict) -> list:
    """Names and units of ``spec`` outside the benchmark's character rules,
    as sentences; empty when all keep them."""
    out = []
    names = ([("config", c["name"]) for c in spec["configs"]]
             + [("cell", w["name"]) for w in spec["workloads"]]
             + [("cell config", w["config"]) for w in spec["workloads"]]
             + [("metric", m["name"]) for m in spec["end_to_end"] + spec["per_layer"]]
             + [("reduced key", k) for c in spec["configs"] for k in c["reduced"]])
    out += [f"{kind} name {n!r}" for kind, n in names if not NAME.fullmatch(n)]
    out += [f"unit {m['unit']!r} of {m['name']}"
            for m in spec["end_to_end"] + spec["per_layer"]
            if not UNIT.fullmatch(m["unit"])]
    return out
