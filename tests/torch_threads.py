"""The port tests' one torch thread policy: two intra-op threads a module.

Tier-1 runs ``pytest -n 6 --dist loadfile``: six workers share the host's
cores, and on an 8-core host each worker's torch would take a pool of 8
intra-op threads beside XLA's own. Under that load a full pool spends its
time contending: run six files at a time on an 8-core host,
``test_torch_train.py::test_cli_round_trip_and_serving[layernorm]`` took
302 s on 8 threads and 46 s on 2, ``test_torch_flagship.py::
test_cli_new_flags`` 457 s and 110 s, and ``test_torch_warmup.py``'s 20
tests did not finish in 600 s on 8 threads against 87 s on 2.

Every ``tests/test_torch_*.py`` module takes the fixture by importing it by
name::

    from torch_threads import few_threads  # noqa: F401

The module name does not start with ``test_``, so pytest does not collect it.
"""

import pytest
import torch


@pytest.fixture(scope="module", autouse=True)
def few_threads():
    """At most two intra-op threads while the importing module runs; the
    host's count comes back when it ends."""
    n = torch.get_num_threads()
    torch.set_num_threads(min(n, 2))
    yield
    torch.set_num_threads(n)
