"""Build the hand-written CUDA kernels in ``csrc/`` and load them with ctypes.

Each ``csrc/<name>.cu`` is compiled by ``nvcc`` for ``sm_90a`` into its own
shared library with a plain C interface (no PyTorch headers, so a build
takes seconds, not minutes).  Builds happen at first use, into
``$MMER_TORCH_BUILD_DIR`` or else ``build/kernels`` next to the package,
under a file name keyed by a hash of the sources and flags: an edited
source never loads a stale library, and an unchanged one is built once.

Every C entry point returns ``cudaGetLastError()`` after its launch;
:func:`call` turns a non-zero code into an exception.  :data:`builds` counts
the libraries :func:`compile_kernel` built in this process (a check that a
warmed server builds nothing more reads it).

Host code in C++ (``csrc/<name>.cpp``: the face detector's cascade
evaluator, the bulk ``.npy`` loader) is built the same way by
:func:`host_library`, with ``g++``.
"""

from __future__ import annotations

import concurrent.futures as cf
import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path
from typing import Callable, Sequence

CSRC = Path(__file__).resolve().parent.parent / "csrc"
KERNELS = ("ffn", "attention", "conv_encoder", "conv_layers", "ln_matmul",
           "threefry", "qdot")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

HOST_LIBRARIES = ("cascade_eval", "npy_loader")
HOST_FLAGS = ("-O3", "-march=native", "-std=c++17", "-shared", "-fPIC",
              "-pthread")

_locks = {name: threading.Lock() for name in KERNELS + HOST_LIBRARIES}
_libs: dict[str, ctypes.CDLL] = {}
_entries: dict[str, Callable[..., int]] = {}
# Kernel libraries compile_kernel built (ran nvcc for) in this process.
builds = 0
_builds_lock = threading.Lock()


def build_dir() -> Path:
    env = os.environ.get("MMER_TORCH_BUILD_DIR")
    return Path(env) if env else CSRC.parent.parent / "build" / "kernels"


def _nvcc() -> str:
    cuda_home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    for cand in (shutil.which("nvcc"), os.path.join(cuda_home, "bin", "nvcc")):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found on PATH or under $CUDA_HOME/bin: the "
                       "CUDA kernels of mmer_tpu_torch cannot be built")


def _library_path(name: str) -> Path:
    digest = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in [CSRC / f"{name}.cu", *sorted(CSRC.glob("*.cuh"))]:
        digest.update(src.name.encode() + src.read_bytes())
    return build_dir() / f"lib{name}-{digest.hexdigest()[:16]}.so"


def compile_kernel(name: str) -> Path:
    """Compile ``csrc/<name>.cu`` unless its library exists; return the path.
    The compiler's report (registers, shared memory, spills per kernel) is
    kept beside the library as ``.log``."""
    global builds
    out = _library_path(name)
    if out.exists():
        return out
    out.parent.mkdir(parents=True, exist_ok=True)
    tmp = out.with_name(f"{out.name}.{os.getpid()}.{threading.get_ident()}.tmp")
    proc = subprocess.run(
        [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")],
        capture_output=True, text=True, check=False)
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"nvcc failed on csrc/{name}.cu:\n{proc.stderr}")
    out.with_suffix(".log").write_text(proc.stdout + proc.stderr)
    os.replace(tmp, out)
    with _builds_lock:
        builds += 1
    return out


def library(name: str) -> ctypes.CDLL:
    """The loaded kernel library ``name``, built first if needed."""
    with _locks[name]:
        lib = _libs.get(name)
        if lib is None:
            lib = ctypes.CDLL(str(compile_kernel(name)))
            lib.mmer_error_string.argtypes = [ctypes.c_int]
            lib.mmer_error_string.restype = ctypes.c_char_p
            _libs[name] = lib
        return lib


def build_all() -> dict[str, float]:
    """Build (in parallel) and load every kernel library; seconds per name."""
    def one(name):
        t0 = time.perf_counter()
        library(name)
        return name, time.perf_counter() - t0

    with cf.ThreadPoolExecutor(len(KERNELS)) as pool:
        return dict(pool.map(one, KERNELS))


def build_report(name: str) -> str:
    """nvcc/ptxas output of the last build of ``name`` ('' if none)."""
    log = _library_path(name).with_suffix(".log")
    return log.read_text() if log.exists() else ""


def call(name: str, symbol: str, argtypes: Sequence, *args) -> None:
    """Call the C entry point ``symbol`` of kernel library ``name`` (built
    and loaded at first use) and raise if it returns a CUDA error."""
    fn = _entries.get(symbol)
    if fn is None:
        fn = getattr(library(name), symbol)
        fn.argtypes = list(argtypes)
        fn.restype = ctypes.c_int
        _entries[symbol] = fn
    rc = fn(*args)
    if rc != 0:
        msg = library(name).mmer_error_string(rc).decode()
        raise RuntimeError(f"{symbol}: CUDA error {rc} ({msg})")


def stream_ptr(device) -> ctypes.c_void_p:
    import torch

    return ctypes.c_void_p(torch.cuda.current_stream(device).cuda_stream)


def ptr(t) -> ctypes.c_void_p:
    return ctypes.c_void_p(t.data_ptr())


def _host_cpu() -> bytes:
    """The build host's CPU model and flags: ``-march=native`` code runs
    only where they hold, so they key the library's name."""
    try:
        with open("/proc/cpuinfo", "rb") as f:
            return b"".join(line for line in f.read().splitlines(True)
                            if line.startswith((b"model name", b"flags")))[:4096]
    except OSError:
        return b""


def _host_library_path(name: str) -> Path:
    digest = hashlib.sha256(" ".join(HOST_FLAGS).encode() + _host_cpu())
    src = CSRC / f"{name}.cpp"
    digest.update(src.name.encode() + src.read_bytes())
    return build_dir() / f"lib{name}-host-{digest.hexdigest()[:16]}.so"


def host_library(name: str) -> ctypes.CDLL:
    """``csrc/<name>.cpp`` built with ``g++`` at first use and loaded.
    Raises when no compiler is found or the build fails."""
    with _locks[name]:
        lib = _libs.get(name)
        if lib is not None:
            return lib
        out = _host_library_path(name)
        if not out.exists():
            cxx = shutil.which("g++")
            if not cxx:
                raise RuntimeError(f"no C++ compiler: csrc/{name}.cpp cannot "
                                   "be built")
            out.parent.mkdir(parents=True, exist_ok=True)
            tmp = out.with_name(
                f"{out.name}.{os.getpid()}.{threading.get_ident()}.tmp")
            proc = subprocess.run(
                [cxx, *HOST_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cpp")],
                capture_output=True, text=True, check=False)
            if proc.returncode != 0:
                tmp.unlink(missing_ok=True)
                raise RuntimeError(f"{cxx} failed on csrc/{name}.cpp:\n"
                                   f"{proc.stderr}")
            os.replace(tmp, out)
        lib = ctypes.CDLL(str(out))
        _libs[name] = lib
        return lib
