"""Run one cell of ``BENCHMARK.json`` once on the card and print its result.

    python3 -m benchmark.run --workload <cell> --seed <n> --seconds <s> --trace <0|1>

From the root of a checkout.  The last line of standard output is one JSON
object: ``correct``, ``attempted``, ``failed``, ``metrics`` (the cell's
end-to-end metrics, or with ``--trace 1`` its per-layer ones), ``device``,
with ``--trace 1`` ``breakdown``, and last ``check``: each number compared
with its limit, which are also the last lines of standard error.  Without a
CUDA device, or with fewer than the cell asks for, it exits 2 and prints no
result; it never falls back to the CPU.  It exits 3 and prints no result if
JAX, flax or the JAX package was loaded.

Every kernel build and cache stays inside the checkout (``build/``), at
fixed paths, so that only a checkout's first run builds.
"""

from __future__ import annotations

import time

STARTED = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
BUILD = ROOT / "build"
CACHES = {"MMER_TORCH_BUILD_DIR": BUILD / "kernels",
          "TORCH_EXTENSIONS_DIR": BUILD / "torch_extensions",
          "TRITON_CACHE_DIR": BUILD / "triton",
          "CUDA_CACHE_PATH": BUILD / "nv_compute_cache"}


def power_limit() -> str:
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=power.limit",
                              "--format=csv,noheader"], capture_output=True,
                             text=True, timeout=30, check=False).stdout
    except (OSError, subprocess.TimeoutExpired):
        return "unknown"
    return out.strip().splitlines()[0] if out.strip() else "unknown"


def result_line(run, cell, device_info: dict) -> dict:
    """The JSON result of a :class:`benchmark.cell.Run` of ``cell``."""
    from benchmark import trace as tracing

    units = {m["name"]: m["unit"] for m in cell.end_to_end + cell.per_layer}
    out = {"correct": run.failed == 0 and run.attempted > 0
           and all(v <= lim for v, lim in run.check.values()),
           "attempted": run.attempted, "failed": run.failed,
           "metrics": {k: {"value": v, "unit": units[k]} for k, v in run.metrics.items()},
           "device": dict(device_info)}
    if run.trace is not None:
        out["device"]["busy_s"] = run.trace.busy_s
        out["device"]["window_s"] = run.trace.window_s
        out["breakdown"] = {"device_ops": tracing.device_ops(run.trace),
                            "idle_gaps": [[n, s] for n, s in run.trace.gaps]}
    out["check"] = {k: {"value": v, "limit": lim} for k, (v, lim) in run.check.items()}
    return out


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = p.parse_args(argv)
    for key, path in CACHES.items():
        os.environ[key] = str(path)

    import torch

    from benchmark import cell as cells, spec

    cell = spec.cell(spec.load(), args.workload)
    if not torch.cuda.is_available() or torch.cuda.device_count() < cell.chips:
        print(f"benchmark: cell {cell.name} needs {cell.chips} CUDA device(s); "
              f"torch.cuda.is_available() is {torch.cuda.is_available()}, "
              f"{torch.cuda.device_count()} device(s)", file=sys.stderr)
        return 2
    device = torch.device("cuda", 0)
    run = cells.run(cell, args.seed, args.seconds, bool(args.trace), device, STARTED)
    foreign = cells.foreign_modules()
    if foreign:
        print(f"benchmark: JAX or the JAX package was loaded: {foreign}", file=sys.stderr)
        return 3
    info = {"platform": "gpu", "kind": torch.cuda.get_device_name(device),
            "count": cell.chips, "memory_peak_bytes": run.memory_peak_bytes,
            "power_limit": power_limit()}
    line = result_line(run, cell, info)
    for text in run.info:
        print(text, file=sys.stderr)
    print(f"cell {cell.name} seed {args.seed}: setup {run.setup_s:.3f} s, window "
          f"{run.window_s:.3f} s, {run.calls} calls, {run.useful:.6g} useful units; "
          f"{info['kind']}, power limit {info['power_limit']}", file=sys.stderr)
    for k, (v, lim) in run.check.items():
        print(f"check {k} = {v!r} (limit {lim!r})", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
