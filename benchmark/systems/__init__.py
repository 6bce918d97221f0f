"""The systems under test, one module a configuration ``kind``: how the
benchmark builds the port's entry from a configuration and a state dict, and
what the inputs of a call ask of it.  Each module has:

- ``build(config, traffic, state, device)`` → :class:`Program`;
- ``useful(arg, config)``: the useful work in a call's argument, in the
  unit of its cells' rate (padding not counted), which each call's record
  carries to the end-to-end readers;
- ``flops(arg, config)``: the model operations that useful work needs;
- ``forwards(arg, config, traffic)``: the device forwards the call implies,
  each a dict of shapes, counted by the benchmark from the configuration
  and the inputs (the traced run's readers and launch check use them);
- ``control(program)``: switch on the port's own int8 path, the control of
  the check (``benchmark.control``).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Callable


@dataclass
class Program:
    """The entry the window drives (``call(arg)`` → host rows, one a useful
    item) and the port object behind it."""

    call: Callable
    target: Any
