"""Per-layer metric readers, one file a metric of ``BENCHMARK.json``'s
``per_layer``, named after it and loaded by path (``spec.module``).  Each has
``read(trace)``, which returns the metric's value from a traced sub-window
(``benchmark.trace.Trace``) or None where it finds nothing to read; a
roofline's reader also has ``launches(trace)``, the launches of its kernels
that the window's shapes imply, which the traced run checks."""
