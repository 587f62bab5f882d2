import numpy as np
import pytest

import jax

# Tests run on the host CPU (1 device). The multi-device dry-run tests spawn
# subprocesses with their own XLA_FLAGS -- never set the flag here.
jax.config.update("jax_enable_x64", False)


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "cuda: needs a CUDA device; the test skips without one")


@pytest.fixture(scope="session")
def small_problem():
    from repro.data.synthetic import LinearDatasetSpec, make_linear_problem

    spec = LinearDatasetSpec(num_workers=4, n_per_worker=128, d=512,
                             nnz_per_row=24, seed=7)
    return make_linear_problem(spec, lam=1e-3, loss="ridge")


@pytest.fixture(scope="session")
def oracle(small_problem):
    """Near-exact optimum of the small problem via long single-machine SDCA."""
    from repro.core.sdca import sdca_reference

    alpha, w = sdca_reference(
        small_problem.global_X(), small_problem.global_y(), small_problem.lam,
        jax.random.key(0), loss="ridge", num_epochs=60)
    return np.asarray(alpha), np.asarray(w)
