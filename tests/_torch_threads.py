"""Give each pytest-xdist worker its share of the cores for torch's
intra-op pool, imported by every ``tests/test_torch_*.py``.

torch sizes its pool to every core of the machine in each process. Under
``-n 6`` on 8 cores six workers then run 48 torch threads beside JAX's
own pools, and the port's tests spend most of their time waiting for
cores: a run of six of the slowest test files under ``-n 6`` took 1,065
s uncapped, 264 s at 2 threads a worker and 177 s at 1. Outside xdist
the pool is left as it is.
"""
import os

import torch

_workers = os.environ.get("PYTEST_XDIST_WORKER_COUNT")
if _workers:
    torch.set_num_threads(max(1, (os.cpu_count() or 1) // int(_workers)))
