"""Device probe, the port of ``mmer_tpu/core/check.py``: the torch and CUDA
versions, the cards, and the bf16 matmul rate of the first one.

    python3 -m mmer_tpu_torch.core.check

Fails without CUDA.  The rate is ``reps`` chained bf16 4096³ ``torch.matmul``
calls timed with CUDA events after a warm-up.
"""

from __future__ import annotations

import torch


def matmul_rate(n: int = 4096, reps: int = 10) -> dict:
    """bf16 (n, n) @ (n, n) on ``cuda:0``: ms a product and TFLOP/s."""
    dev = torch.device("cuda", 0)
    x = torch.full((n, n), 1e-4, dtype=torch.bfloat16, device=dev)
    y = x
    for _ in range(3):
        y = torch.matmul(x, x)
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    start.record()
    for _ in range(reps):
        y = torch.matmul(y, x)
    end.record()
    end.synchronize()
    ms = start.elapsed_time(end) / reps
    return {"n": n, "ms": ms, "tflops": 2 * n ** 3 / ms / 1e9}


def main() -> dict:
    if not torch.cuda.is_available():
        raise SystemExit("check: torch.cuda.is_available() is False")
    print(f"torch {torch.__version__}, CUDA {torch.version.cuda}")
    print("devices: " + ", ".join(torch.cuda.get_device_name(i)
                                  for i in range(torch.cuda.device_count())))
    rate = matmul_rate()
    print(f"bf16 {rate['n']}^3 matmul: {rate['ms']:.3f} ms "
          f"({rate['tflops']:.1f} TFLOP/s)")
    return rate


if __name__ == "__main__":
    main()
