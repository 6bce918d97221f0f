"""The port's quality scripts and frontend demo against the JAX package's
scripts, on the CPU.

Each of the eight quality scripts runs twice, the JAX script (imported, not edited)
and the port, with recording stubs in place of the trainers and the ensemble
and distillation helpers: both must make the same calls in the same order
(configs, seeds, batch sizes, epochs, members), print the same lines and end
on the same summary from the same canned results.  One of them also runs for
real on the tiny feature folders, JAX and port seed for seed.  The demo's
build function serves its routes over HTTP with a tiny engine.
"""

import dataclasses
import importlib
import json
import sys
import threading
import types
import urllib.request
import uuid
from http.server import ThreadingHTTPServer

import numpy as np
import pytest
import torch

import scripts.probe_feature_noise_quality as jax_noise

QUALITY_SCRIPTS = ["sweep", "quality_sweep", "probe_recipe_sweep_r4", "probe_ensemble",
           "probe_diverse_ensemble", "probe_mixup_quality",
           "probe_feature_noise_quality", "probe_distill"]
N = 24
LABELS = np.arange(N) % 6


def _fake_dataset():
    data = types.SimpleNamespace(max_chunks=5, labels=LABELS.astype(np.int32))
    splits = types.SimpleNamespace(train=np.arange(0, 16), val=np.arange(16, 20),
                                   test=np.arange(20, 24))
    return data, splits


def _cfg(c):
    d = dataclasses.asdict(c)
    d.pop("output_dir", None)       # the JAX scripts' /tmp paths, the port's tempdir
    return d


def _rows(key, n_epochs=3):
    """Canned per-epoch rows, a function of ``key`` only."""
    rng = np.random.default_rng(abs(hash(key)) % 2 ** 32)
    return [{"epoch": e + 1, "train_loss": float(rng.random()),
             "val_loss": float(rng.random()), "test_acc": float(100 * rng.random()),
             "test_macro_f1": float(rng.random())} for e in range(n_epochs)]


def _f1(members):
    return float(np.random.default_rng(abs(hash(tuple(members))) % 2 ** 32).random())


class Recorder:
    """The stubs of one run, each call appended to ``calls``."""

    def __init__(self):
        self.calls = []
        self.n = 0

    def _next(self):
        self.n += 1
        return self.n

    def train_model(self, data, splits, model_cfg, train_cfg, batch_size=64,
                    seed=0, verbose=True, fused=False, device=None, **kw):
        k = self._next()
        self.calls.append(("train_model", _cfg(model_cfg), _cfg(train_cfg),
                           batch_size, seed, verbose, fused, sorted(kw)))
        rows = _rows(("tm", k))
        return types.SimpleNamespace(results=rows, best_epoch=2,
                                     hyperparameters={"train_wall_seconds": 1.5 * k})

    def train_many_seeds(self, data, splits, model_cfg, train_cfg, batch_size,
                         seeds, seeds_per_call=4, epochs_per_call=100,
                         verbose=True, soft_targets=None, device=None):
        k = self._next()
        soft = None if soft_targets is None else np.asarray(soft_targets).tolist()
        self.calls.append(("train_many_seeds", _cfg(model_cfg), _cfg(train_cfg),
                           batch_size, list(seeds), seeds_per_call,
                           epochs_per_call, verbose, soft))
        return [{"seed": s, "results": _rows(("tms", k, s)), "best_epoch": 1 + s % 3,
                 "best_score": float(_f1([k, s])), "best_params": f"P{k}.{s}",
                 "wall_seconds": 1.0} for s in seeds]

    def ensemble_eval(self, model_cfg, params_list, data, splits, split="test",
                      device=None):
        self.calls.append(("ensemble_eval", _cfg(model_cfg), list(params_list),
                           split))
        f1 = _f1(params_list)
        return {"n_members": len(params_list), "ensemble_macro_f1": f1,
                "ensemble_accuracy": f1 / 2, "member_mean_macro_f1": f1 / 3}

    def greedy_ensemble_eval(self, model_cfg, params_list, data, splits, k_max,
                             replace=False, device=None):
        self.calls.append(("greedy", _cfg(model_cfg), list(params_list), k_max,
                           replace))
        return {"k_best": 2, "val_f1_path": [0.5, 0.6], "order": [1, 0],
                "test_macro_f1": round(_f1(params_list + [replace]), 6)}

    def soup_params(self, members):
        self.calls.append(("soup", list(members)))
        return "soup(" + ",".join(members) + ")"

    def teacher_soft_targets(self, model_cfg, params_list, data, device=None):
        self.calls.append(("soft", _cfg(model_cfg), list(params_list)))
        rng = np.random.default_rng(len(params_list))
        p = rng.random((N, 6)).astype(np.float32)
        return p / p.sum(1, keepdims=True)

    def dataset_from_features(self, videos, audios, labels, keys, cfg):
        self.calls.append(("dataset", [v.copy() for v in videos],
                           np.array(audios), np.array(labels), list(keys)))
        return _fake_dataset()


def _catalog():
    return [types.SimpleNamespace(label=int(LABELS[i]), key=f"k{i}")
            for i in range(N)]


def _feature_arrays(catalog):
    rng = np.random.default_rng(9)
    videos = [rng.normal(size=(1 + i % 3, 8)).astype(np.float32)
              for i in range(len(catalog))]
    audios = rng.normal(size=(len(catalog), 6)).astype(np.float16)
    return videos, audios


def _patch(monkeypatch, rec, package: str):
    """The stubs in place in ``package`` (``mmer_tpu`` or ``mmer_tpu_torch``),
    where the scripts look them up when they run."""
    def mod(name):
        return importlib.import_module(f"{package}.{name}")

    if package == "mmer_tpu":
        monkeypatch.setattr(mod("core.cache"), "enable_persistent_cache",
                            lambda *a, **k: None)
    pipeline = mod("data.pipeline")
    monkeypatch.setattr(pipeline, "load_dataset", lambda cfg: _fake_dataset())
    monkeypatch.setattr(pipeline, "load_feature_arrays", _feature_arrays)
    monkeypatch.setattr(pipeline, "dataset_from_features", rec.dataset_from_features)
    monkeypatch.setattr(mod("data.catalog"), "build_catalog", lambda *a: _catalog())
    monkeypatch.setattr(mod("train.loop"), "train_model", rec.train_model)
    monkeypatch.setattr(mod("train.fused"), "train_many_seeds", rec.train_many_seeds)
    for name in ("ensemble_eval", "greedy_ensemble_eval", "soup_params"):
        monkeypatch.setattr(mod("train.ensemble"), name, getattr(rec, name))
    monkeypatch.setattr(mod("train.distill"), "teacher_soft_targets",
                        rec.teacher_soft_targets)


# Arguments each quality script runs with (both sides), beyond the port's --device.
ARGS = {
    "sweep": ["--epochs", "7"],
    "quality_sweep": [],
    "probe_recipe_sweep_r4": ["--seeds", "3", "--epochs", "5",
                              "--seeds_per_call", "2", "--only", "baseline,bs32,3layers"],
    "probe_ensemble": ["--seeds", "5", "--epochs", "9"],
    "probe_diverse_ensemble": ["--seeds", "3", "--epochs", "4", "--greedy"],
    "probe_mixup_quality": ["--seeds", "2", "--arms", "baseline,mixup0.4,mdrop0.2"],
    "probe_feature_noise_quality": ["--levels", "0,0.01,0.05", "--seeds", "3",
                                    "--modality", "both"],
    "probe_distill": ["--pool_seeds", "3", "--student_seeds", "2", "--teacher_k", "5",
                      "--grid", "0.5:1,1.0:2"],
}


def _same(a, b):
    if isinstance(a, np.ndarray) or isinstance(b, np.ndarray):
        return np.array_equal(a, b) and np.asarray(a).dtype == np.asarray(b).dtype
    if isinstance(a, (list, tuple)) and isinstance(b, (list, tuple)):
        return len(a) == len(b) and all(_same(x, y) for x, y in zip(a, b))
    return a == b


@pytest.mark.parametrize("name", QUALITY_SCRIPTS)
def test_quality_script_makes_jax_calls_and_summary(name, monkeypatch, capsys, tmp_path):
    args = list(ARGS[name])
    jax_args, port_args = list(args), list(args)
    if name in ("probe_distill", "probe_mixup_quality"):
        jax_args += ["--out", str(tmp_path / "jax.json")]
        port_args += ["--out", str(tmp_path / "port.json")]

    jax_rec = Recorder()
    with monkeypatch.context() as m:
        _patch(m, jax_rec, "mmer_tpu")
        m.setattr(sys, "argv", [f"{name}.py", *jax_args])
        importlib.import_module(f"scripts.{name}").main()
    jax_out = capsys.readouterr().out

    port_rec = Recorder()
    with monkeypatch.context() as m:
        _patch(m, port_rec, "mmer_tpu_torch")
        summary = importlib.import_module(f"mmer_tpu_torch.scripts.{name}").main(
            port_args + ["--device", "cpu"])
    port_out = capsys.readouterr().out

    assert len(port_rec.calls) == len(jax_rec.calls) > 0
    for got, want in zip(port_rec.calls, jax_rec.calls):
        assert _same(got, want), (got, want)
    assert port_out == jax_out
    last = json.loads(jax_out.strip().splitlines()[-1]) \
        if jax_out.strip().splitlines()[-1].startswith(("{", "[")) else None
    if name in ("sweep", "quality_sweep"):
        rows = [json.loads(line) for line in jax_out.splitlines()
                if line.startswith("{")]
        assert summary == sorted(rows, key=lambda r: -r["test_macro_f1"])
    elif name == "probe_ensemble":
        assert summary["ensemble"][f"k={5}"] == last
    else:
        assert json.loads(json.dumps(summary)) == last
    if name in ("probe_distill", "probe_mixup_quality"):
        assert (json.loads((tmp_path / "port.json").read_text())
                == json.loads((tmp_path / "jax.json").read_text()))


def test_probe_distill_writes_nothing_without_out(monkeypatch, tmp_path):
    """The JAX script's default ``--out`` is a committed file; the port
    writes no file unless ``--out`` is given."""
    monkeypatch.chdir(tmp_path)
    rec = Recorder()
    _patch(monkeypatch, rec, "mmer_tpu_torch")
    from mmer_tpu_torch.scripts import probe_distill

    summary = probe_distill.main(["--pool_seeds", "2", "--student_seeds", "2",
                                  "--grid", "0.5:1", "--device", "cpu"])
    assert "teacher_test_f1" in summary and list(tmp_path.iterdir()) == []


def test_noised_bit_equal_to_jax():
    from mmer_tpu_torch.scripts.probe_feature_noise_quality import _noised

    base = np.random.default_rng(2)
    arrs = [base.normal(size=(1 + i, 768)).astype(np.float32) for i in range(4)]
    auds = list(base.normal(size=(3, 1024)).astype(np.float16))
    for rel in (0.0, 0.01, 0.05):
        for a in (arrs, auds):
            want = jax_noise._noised(a, rel, np.random.default_rng(1234))
            got = _noised(a, rel, np.random.default_rng(1234))
            assert len(got) == len(want)
            for g, w in zip(got, want):
                assert g.dtype == w.dtype and np.array_equal(g, w)


def test_recipe_sweep_real_run_matches_jax(synthetic_feature_dirs, monkeypatch,
                                           capsys):
    """``--only baseline --seeds 2 --epochs 2`` through both on the tiny
    feature folders: per seed the best-epoch and the validation-selected
    test macro-F1 within 1e-4 (the trainers' whole-run tolerance)."""
    import mmer_tpu.config as jax_config
    import mmer_tpu.core.cache as cache
    import mmer_tpu.data.pipeline as jax_pipeline
    import mmer_tpu.train.fused as jax_fused
    import mmer_tpu_torch.train.fused as port_fused
    from mmer_tpu_torch.scripts import probe_recipe_sweep_r4

    vdir, adir = synthetic_feature_dirs
    runs = {}

    def recording(key, fn):
        def wrapped(*a, **k):
            runs[key] = fn(*a, **k)
            return runs[key]
        return wrapped

    real_load = jax_pipeline.load_dataset
    monkeypatch.setattr(cache, "enable_persistent_cache", lambda *a, **k: None)
    monkeypatch.setattr(jax_pipeline, "load_dataset", lambda cfg: real_load(
        jax_config.DataConfig(video_feat_dir=vdir, audio_feat_dir=adir)))
    monkeypatch.setattr(jax_fused, "train_many_seeds",
                        recording("jax", jax_fused.train_many_seeds))
    monkeypatch.setattr(port_fused, "train_many_seeds",
                        recording("port", port_fused.train_many_seeds))
    args = ["--only", "baseline", "--seeds", "2", "--epochs", "2"]
    monkeypatch.setattr(sys, "argv", ["probe_recipe_sweep_r4.py", *args])
    importlib.import_module("scripts.probe_recipe_sweep_r4").main()
    n = torch.get_num_threads()
    torch.set_num_threads(min(n, 2))
    try:
        board = probe_recipe_sweep_r4.main(args + ["--video_feat_dir", vdir,
                                                   "--audio_feat_dir", adir,
                                                   "--device", "cpu"])
    finally:
        torch.set_num_threads(n)
    capsys.readouterr()
    assert [r["tag"] for r in board] == ["baseline"]
    assert len(runs["port"]) == len(runs["jax"]) == 2
    for g, w in zip(runs["port"], runs["jax"]):
        assert g["seed"] == w["seed"] and len(g["results"]) == len(w["results"]) == 2
        for key in ("best", "sel"):
            pick = (max, "test_macro_f1") if key == "best" else (min, "val_loss")
            gf = pick[0](g["results"], key=lambda r: r[pick[1]])["test_macro_f1"]
            wf = pick[0](w["results"], key=lambda r: r[pick[1]])["test_macro_f1"]
            assert abs(gf - wf) <= 1e-4, (key, gf, wf)


def _multipart(name: str, payload: bytes):
    b = uuid.uuid4().hex
    body = (f"--{b}\r\nContent-Disposition: form-data; name=\"file\"; "
            f"filename=\"{name}\"\r\nContent-Type: video/mp4\r\n\r\n").encode() \
        + payload + f"\r\n--{b}--\r\n".encode()
    return body, f"multipart/form-data; boundary={b}"


def test_demo_frontend_serves_clip_and_infers(tmp_path):
    """The demo's build function: ``/`` (the frontend), ``/static/demo.mp4``
    (the written bytes) and ``/infer/`` on the clip with the tiny engine."""
    pytest.importorskip("cv2")
    from mmer_tpu_torch.scripts.demo_frontend import build_demo
    from mmer_tpu_torch.serve.app import make_handler

    n = torch.get_num_threads()
    torch.set_num_threads(min(n, 2))
    engine, extra = build_demo(torch.device("cpu"), str(tmp_path), frames=24)
    srv = ThreadingHTTPServer(("127.0.0.1", 0), make_handler(engine,
                                                             extra_static=extra))
    thread = threading.Thread(target=srv.serve_forever, daemon=True)
    thread.start()
    try:
        url = f"http://127.0.0.1:{srv.server_address[1]}"
        with urllib.request.urlopen(url + "/") as r:
            assert r.status == 200 and b"<html" in r.read().lower()
        with urllib.request.urlopen(url + "/static/demo.mp4") as r:
            clip = r.read()
        with open(extra["/static/demo.mp4"][0], "rb") as f:
            assert clip == f.read() and len(clip) > 1000
        body, ctype = _multipart("demo.mp4", clip)
        req = urllib.request.Request(
            url + "/infer/?subchunk_size=4&window_size=2&detect_every=3",
            data=body, headers={"Content-Type": ctype})
        with urllib.request.urlopen(req) as r:
            res = json.loads(r.read())
    finally:
        srv.shutdown()
        srv.server_close()
        torch.set_num_threads(n)
    assert len(res["bounding_box"]) == 24
    assert res["inference"]
    for item in res["inference"]:
        assert item["class"] in engine.labels and 0 <= item["frame"] < 24
