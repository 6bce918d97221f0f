"""``setup_s`` (s): the process's start to the window's: imports, the CUDA
context, the seeded traffic and weights, the entry built, and every distinct
call of the traffic's period run once (on a checkout's first run, nvcc
too)."""


def read(window):
    return window.setup_s
