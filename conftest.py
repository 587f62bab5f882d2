"""One intra-op thread budget for the test workers.

Under ``pytest -n N`` the N xdist workers share the machine's cores, and
PyTorch's default of one intra-op thread a core would give each worker all of
them: at the CPU tests' sizes the extra threads buy nothing alone, and with
every worker spinning its own set a test runs many times slower than it does
by itself. So each worker takes its share of the cores, and at least one
thread. Without xdist nothing changes. No environment variable is set, so the
subprocesses that tests start keep their own defaults (the dry-run's set their
own ``XLA_FLAGS`` too; see ``tests/conftest.py``).
"""

import os


def pytest_configure(config):
    workers = os.environ.get("PYTEST_XDIST_WORKER_COUNT")
    if workers is None:
        return
    import torch

    torch.set_num_threads(max(1, (os.cpu_count() or 1) // int(workers)))
