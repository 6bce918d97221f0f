"""Operators with a hand-written CUDA kernel and their plain PyTorch versions."""
