"""torch's intra-op threads for the port's tests under pytest-xdist.

torch starts every process with an intra-op thread a core, so several xdist
workers running torch at once oversubscribe the cores and slow every test
on the machine, the JAX package's too. Each port test module calls
`share_cores()` when it is imported: under xdist it gives its worker an
equal share of the cores; outside xdist it changes nothing.
"""
import os

import torch


def share_cores():
    workers = os.environ.get("PYTEST_XDIST_WORKER_COUNT")
    if os.environ.get("PYTEST_XDIST_WORKER") and workers:
        torch.set_num_threads(max(1, os.cpu_count() // int(workers)))
