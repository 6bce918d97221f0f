"""Run a function on every rank of a CPU world of gloo processes.

``torchrun`` launches a world on the card (one process per GPU, NCCL); on the
CPU the scaling probe, the dry run and the tests spawn their ranks here:
``spawn`` start method, a TCP rendezvous on a free local port, a process
group timeout, and a deadline for the whole world, after which every rank is
stopped and the call raises.  A rank that raises stops the world at once.
"""

from __future__ import annotations

import os
import queue
import socket
import sys
import time
import traceback
from datetime import timedelta
from typing import Any, Callable, List, Optional, Sequence


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _rank_main(fn, rank: int, world: int, port: int, pg_timeout_s: float,
               threads: int, args: Sequence, results) -> None:
    import torch
    import torch.distributed as dist

    try:
        torch.set_num_threads(threads)
        dist.init_process_group(
            "gloo", init_method=f"tcp://127.0.0.1:{port}", rank=rank,
            world_size=world, timeout=timedelta(seconds=pg_timeout_s))
        try:
            out = fn(*args)
        finally:
            dist.destroy_process_group()
        results.put((rank, True, out))
    except BaseException:                   # reported, then the rank exits
        results.put((rank, False, traceback.format_exc()))
        sys.exit(1)


def spawn_cpu_world(fn: Callable, world: int, args: Sequence = (), *,
                    timeout_s: float = 120.0,
                    pg_timeout_s: float = 60.0,
                    threads: Optional[int] = None) -> List[Any]:
    """``fn(*args)`` on each of ``world`` spawned gloo ranks → the ranks'
    return values in rank order.  ``fn`` and ``args`` must pickle (``fn`` a
    module-level function).  Raises if a rank raises or exits without a
    result, or if the world has not finished ``timeout_s`` after the start;
    no rank outlives the call.  Each rank runs ``threads`` intra-op threads;
    by default the ranks share the host's cores out.  On a host that other
    work keeps busy, pass 1: idle-waiting OpenMP threads of several
    processes on too few cores slow small operations many times over."""
    import multiprocessing as mp

    ctx = mp.get_context("spawn")
    results = ctx.Queue()
    if threads is None:
        threads = max(1, (os.cpu_count() or 1) // world)
    port = free_port()
    procs = [ctx.Process(target=_rank_main, daemon=True,
                         args=(fn, rank, world, port, pg_timeout_s, threads,
                               tuple(args), results))
             for rank in range(world)]
    for p in procs:
        p.start()
    out: dict = {}
    deadline = time.monotonic() + timeout_s
    grace = 10.0           # for the ranks' exits after their results
    try:
        while len(out) < world:
            left = deadline - time.monotonic()
            if left <= 0:
                raise TimeoutError(f"a world of {world} ranks did not finish in "
                                   f"{timeout_s} s")
            try:
                rank, ok, payload = results.get(timeout=min(left, 1.0))
            except queue.Empty:
                dead = [r for r, p in enumerate(procs)
                        if r not in out and p.exitcode not in (None, 0)]
                if dead:
                    raise RuntimeError(f"rank(s) {dead} exited without a result")
                continue
            if not ok:
                raise RuntimeError(f"rank {rank} of {world} failed:\n{payload}")
            out[rank] = payload
    except BaseException:
        grace = 0.0        # a failed world is stopped at once
        raise
    finally:
        for p in procs:
            p.join(timeout=grace)
            if p.is_alive():
                p.terminate()
                p.join(timeout=5)
            if p.is_alive():
                p.kill()
                p.join()
        results.close()
    return [out[r] for r in range(world)]
