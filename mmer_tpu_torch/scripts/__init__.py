"""Kernel-level profile and probe scripts of the port (run with ``python3 -m``)."""
