"""Torch's intra-op threads for the port's tests.

Under pytest-xdist every worker is a process whose OpenMP pool would take
every core; six workers on eight cores then spin against each other (six
ResNet-50 CPU train steps at once on an 8-core host took 184 s each
against 1.5 s at two threads a worker). Importing this
module gives each worker its share of the cores, at least one; without
xdist the count stays torch's default. Every worker imports every test
module when it collects, so the share holds for the whole run. No
result depends on it beyond the order of a reduction, which the tests'
bounds already cover."""
import os

import torch


def share_cores() -> int:
    workers = int(os.environ.get("PYTEST_XDIST_WORKER_COUNT", "0") or 0)
    if workers > 1:
        torch.set_num_threads(max(1, (os.cpu_count() or 1) // workers))
    return torch.get_num_threads()


THREADS = share_cores()
