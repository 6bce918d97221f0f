"""The benchmark of ``mmer_tpu_torch`` on one NVIDIA H100.

``python3 -m benchmark.run --workload <cell> --seed <n> --seconds <s>
--trace <0|1>`` runs one cell of ``BENCHMARK.json`` once and prints one JSON
line.  Everything a cell needs is found by name: its configuration in
``configs/<config>.json`` (whose ``kind`` names a module of ``systems/`` and
of ``reference/``), its traffic in ``workloads/<cell>.json`` (whose
``generator`` names a module of ``traffic/`` and whose parameters set the
schedule, closed loop or arrivals at a rate), each end-to-end metric in
``end_to_end/<metric>.py`` and each per-layer metric in
``metrics/<metric>.py``.  This folder is the yardstick: it imports nothing of
the JAX package, and of the port only the system under test.
"""
