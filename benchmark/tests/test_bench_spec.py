"""``BENCHMARK.json`` keeps the benchmark's rules for names and units, and a
new configuration, cell or per-layer metric is picked up from new files and
entries alone."""

import json
import shutil

from benchmark import spec
from benchmark.run import result_line
from benchmark.tests.conftest import cpu_run, tiny_cell


def test_names_and_units_keep_the_rules():
    s = spec.load()
    assert spec.problems(s) == []
    for m in s["end_to_end"] + s["per_layer"]:
        assert m["better"] in ("lower", "higher")
    assert {m["name"] for m in s["end_to_end"]} == {"chunks_per_s", "audio_s_per_s",
                                                     "setup_s"}


def test_problems_names_a_bad_name_and_unit():
    s = json.loads(json.dumps(spec.load()))
    s["workloads"][0]["name"] = "bad name"
    s["per_layer"][0]["unit"] = "ms per chunk"
    assert len(spec.problems(s)) == 2


def test_every_cell_metric_and_config_has_its_files():
    s = spec.load()
    for w in s["workloads"]:
        c = spec.cell(s, w["name"])
        assert c.config["kind"] in ("vivit", "wav2vec2")
        for m in c.per_layer:
            assert hasattr(spec.module("metrics", m["name"]), "read")
        for m in c.end_to_end:
            assert hasattr(spec.module("end_to_end", m["name"]), "read")
        for m in c.per_layer + c.end_to_end:
            assert w["name"] in m.get("workloads", [w["name"]])


def test_new_files_add_a_config_a_cell_and_a_metric(tmp_path):
    """A copy of the benchmark with one more configuration, cell and
    per-layer metric, each a new file and a new entry: the new cell runs
    and reports the new metric; the files that were there are unchanged."""
    shutil.copytree(spec.ROOT / "benchmark", tmp_path / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__"))
    s = spec.load()
    before = {p: p.read_bytes() for p in (tmp_path / "benchmark").rglob("*") if p.is_file()}
    conf = json.loads((tmp_path / "benchmark/configs/vivit-b16-t4.json").read_text())
    conf["model"]["depth"] = 1
    (tmp_path / "benchmark/configs/vivit-b1.json").write_text(json.dumps(conf))
    (tmp_path / "benchmark/workloads/vivit-b1.pairs.json").write_text(json.dumps(
        {"generator": "video_chunks", "sizes": [2, 2], "device_batch": 2,
         "pipeline": False, "trace_calls": 2, "limits": {"worst_rel_l2": 1e-3}}))
    (tmp_path / "benchmark/metrics/calls_seen.vivit.py").write_text(
        "def read(t):\n    return float(t.calls)\n")
    s["configs"].append({"name": "vivit-b1", "source": "https://arxiv.org/abs/2103.15691",
                         "file": "benchmark/configs/vivit-b1.json", "reduced": ["depth"],
                         "why": "one layer"})
    s["workloads"].append({"name": "vivit-b1.pairs", "config": "vivit-b1",
                           "traffic": "pairs", "chips": 1, "why": "pairs"})
    s["end_to_end"][0]["workloads"].append("vivit-b1.pairs")
    s["per_layer"].append({"name": "calls_seen.vivit", "unit": "calls", "better": "higher",
                           "source": "program_counter", "layer": "batching, host",
                           "moves": "chunks_per_s", "workloads": ["vivit-b1.pairs"]})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(s))

    assert spec.cell(spec.load(tmp_path), "vivit-b1.pairs",
                     tmp_path).config["model"]["depth"] == 1
    c = tiny_cell("vivit-b1.pairs", root=tmp_path)
    assert c.traffic["sizes"] == [2, 2]
    traced = cpu_run(c, traced=True)
    assert traced.metrics["calls_seen.vivit"] == 2.0
    assert "mfu.vivit" not in traced.metrics            # listed for other cells
    plain = cpu_run(c)
    assert set(plain.metrics) == {"chunks_per_s", "setup_s"}
    assert result_line(plain, c, {})["correct"]
    assert all(p.read_bytes() == b for p, b in before.items())


def test_new_files_add_an_open_loop_cell_and_a_latency_metric(tmp_path):
    """A cell whose workload file sets ``rate_per_s`` is driven open loop,
    and a new end-to-end metric read from each call's arrival and return is
    reported, from new files and entries alone."""
    shutil.copytree(spec.ROOT / "benchmark", tmp_path / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__"))
    s = spec.load()
    (tmp_path / "benchmark/workloads/vivit-b.requests.json").write_text(json.dumps(
        {"generator": "video_chunks", "sizes": [1, 2, 3], "device_batch": 4,
         "pipeline": False, "trace_calls": 2, "rate_per_s": 8.0,
         "limits": {"worst_rel_l2": 1e-3}}))
    (tmp_path / "benchmark/end_to_end/call_ms_p95.py").write_text(
        "import numpy as np\n"
        "def read(w):\n"
        "    return float(np.percentile([1e3 * (c.end - c.arrival) for c in w.calls], 95))\n")
    s["workloads"].append({"name": "vivit-b.requests", "config": "vivit-b16-t4",
                           "traffic": "requests", "chips": 1, "why": "requests"})
    s["end_to_end"].insert(0, {"name": "call_ms_p95", "unit": "ms", "better": "lower",
                               "bound": 0.1, "source": "host_clock",
                               "workloads": ["vivit-b.requests"]})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(s))

    c = tiny_cell("vivit-b.requests", root=tmp_path)
    run = cpu_run(c)
    assert set(run.metrics) == {"call_ms_p95", "setup_s"}
    assert run.metrics["call_ms_p95"] > 0
    assert result_line(run, c, {})["correct"]
