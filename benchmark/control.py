"""The readings a cell's limits are set from: the program on many seeds, and
each chosen control and fault on three seeds or more, all in one process
and each a short window at the cell's own load.  The benchmark's own runs
never run it.

    python3 -m benchmark.control --workload <cell> --seeds 1,2,... \\
        --control-seeds 101,102,103 [--faults tubelets_reversed,...] --seconds 2

The controls, put in the program's place:

- ``int8`` (the default, every cell's control): the port's own int8 path
  switched on (``systems/<kind>.py:control``), the step below bf16;
- ``bf16``: the plain reference computed in bfloat16 throughout (weights,
  stream, attention), the step below the float32 parts that the Wav2Vec2
  configuration states (PERF.md §2 says why no limit separates it).

Faults are ``benchmark.faults``'s, planted in the port.  One JSON line a run
(``arm``: ``program``, a control or a fault; the compared numbers, the rows'
spread, the rate), then a summary line: for each arm and compared number
the largest program reading, the arm's smallest and their ratio.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

import torch

from benchmark.run import CACHES

LOWER = {"bf16": torch.bfloat16}


def control(cell, name: str):
    """The hook ``hook(program, state)`` that puts control ``name`` in the
    program's place."""
    from benchmark import cell as cells

    system, reference, _ = cells.modules(cell)
    if name == "int8":
        return lambda program, state: system.control(program)
    dtype, m = LOWER[name], cell.config["model"]

    def hook(program, state):
        low = {k: v.to(dtype) for k, v in state.items()}
        device = next(iter(low.values())).device
        program.call = lambda arg: reference.outputs(low, m, arg, device,
                                                     dtype=dtype).numpy()
    return hook


def readings(cell, seeds, arm: str, seconds: float, device) -> list:
    from benchmark import cell as cells, faults

    hook = (None if arm == "program" else
            faults.plant(arm) if arm in faults.OUTPUT or arm in faults.INPUT
            else control(cell, arm))
    rows = []
    for seed in seeds:
        run = cells.run(cell, seed, seconds, False, device, time.perf_counter(),
                        hook=hook)
        row = {"arm": arm, "seed": seed,
               **{k: v for k, (v, _) in run.check.items()}, **run.summary,
               "rate": run.useful / run.window_s, "calls": run.calls,
               "setup_s": run.setup_s}
        print(json.dumps(row), flush=True)
        rows.append(row)
    return rows


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", default="", help="comma-separated program seeds")
    p.add_argument("--control-seeds", default="",
                   help="comma-separated seeds of the controls and faults")
    p.add_argument("--controls", default="int8", help="comma-separated controls")
    p.add_argument("--faults", default="", help="comma-separated faults")
    p.add_argument("--seconds", type=float, default=2.0)
    args = p.parse_args(argv)
    for key, path in CACHES.items():
        os.environ[key] = str(path)

    from benchmark import spec

    if not torch.cuda.is_available():
        print("benchmark.control: needs a CUDA device", file=sys.stderr)
        return 2
    device = torch.device("cuda", 0)
    cell = spec.cell(spec.load(), args.workload)
    def split(text):
        return [x for x in text.split(",") if x]

    seeds = [int(s) for s in split(args.seeds)]
    cseeds = [int(s) for s in split(args.control_seeds)]
    arms = split(args.controls) + split(args.faults)
    prog = readings(cell, seeds, "program", args.seconds, device)
    summary = {"workload": cell.name, "device": torch.cuda.get_device_name(device)}
    for arm in arms:
        got = readings(cell, cseeds, arm, args.seconds, device)
        for key in ("worst_rel_l2", "bias_rel_l2", "median"):
            lower = max(r[key] for r in prog) if prog else None
            upper = min(r[key] for r in got) if got else None
            summary[f"{arm}.{key}"] = {"lower": lower, "upper": upper,
                                       "ratio": upper / lower if lower and upper else None}
    print(json.dumps(summary), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
