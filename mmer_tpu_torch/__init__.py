"""mmer_tpu_torch — the PyTorch / CUDA port of ``mmer_tpu`` for NVIDIA Hopper.

It mirrors ``mmer_tpu``'s module paths (``ops/flash_attention.py``,
``models/vivit.py``, ...) so each module's counterpart is easy to find.
It imports ``torch`` and never JAX, flax or ``mmer_tpu``; the kernels that
the JAX package wrote in Pallas for the TPU are hand-written CUDA C++ for
``sm_90a`` under ``csrc/``, built with ``nvcc`` at first use.
"""

__version__ = "0.1.0"
