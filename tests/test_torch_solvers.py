"""Port vs JAX package: the local-solver registry (``core/solvers.py``).

Each entry solves all K workers at once in the port; the JAX package vmaps
its single-worker entry over the workers. Both get the same seeded numpy
inputs and the same keys: the port's draw source replays JAX's draws
(``randint`` for ``sdca`` and for each round of ``accelerated`` after its
``split(key, num_rounds)``, ``choice`` with the importance weights for
``importance``). Tolerance rtol 1e-4 / atol 1e-5: the same float32 steps,
with the dot products summed in another order and compounded over the
dependent steps and rounds.
"""

from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import solvers as jsolvers
from repro_torch.core import solvers as tsolvers
from repro_torch.core.sdca import TorchDraws
from repro_torch.kernels import ops

from test_torch_engine import JaxDraws

RTOL, ATOL = 1e-4, 1e-5


def _inputs(K, n_k, d, loss):
    rng = np.random.default_rng(K * 100 + d)
    X = (rng.standard_normal((K, n_k, d)) / np.sqrt(d)).astype(np.float32)
    X *= rng.uniform(0.2, 3.0, (K, n_k, 1)).astype(np.float32)  # uneven row norms
    y = np.sign(rng.standard_normal((K, n_k))).astype(np.float32)
    w = (rng.standard_normal((K, d)) * 0.1).astype(np.float32)
    if loss == "ridge":
        alpha = (rng.standard_normal((K, n_k)) * 0.05).astype(np.float32)
    else:  # dual-feasible: y * alpha in (0, 1)
        alpha = (y * rng.uniform(0.05, 0.6, (K, n_k))).astype(np.float32)
    norms = np.sum(X * X, axis=-1)
    return w, alpha, X, y, norms


def test_registry_names_and_errors():
    assert tsolvers.available_solvers() == jsolvers.available_solvers() == (
        "accelerated", "importance", "sdca")
    with pytest.raises(ValueError, match="unknown local solver 'nope'"):
        tsolvers.get_solver("nope")


@pytest.mark.parametrize("name", ["sdca", "importance", "accelerated"])
@pytest.mark.parametrize("loss", ["ridge", "smoothed_hinge", "logistic"])
@pytest.mark.parametrize("K,n_k,d,H", [(4, 32, 256, 40), (3, 64, 128, 61)])
def test_solver_matches_jax_on_replayed_draws(name, loss, K, n_k, d, H):
    arrays = _inputs(K, n_k, d, loss)
    lam, n, sp = 1e-3, K * n_k, 2.5
    keys = list(jax.random.split(jax.random.key(K + H), K))
    jfn = partial(jsolvers.get_solver(name), loss=loss, num_steps=H)
    j = jax.vmap(jfn, in_axes=(0, 0, 0, 0, 0, None, None, None, 0))(
        *map(jnp.asarray, arrays), lam, n, sp, jnp.stack(keys))
    before = dict(ops.LAUNCHES)
    t = tsolvers.get_solver(name)(*map(torch.from_numpy, arrays), lam, n, sp, keys,
                                  JaxDraws(0), loss=loss, num_steps=H)
    assert ops.LAUNCHES == before  # the plain version on the host
    np.testing.assert_allclose(t.delta_alpha.numpy(), np.asarray(j.delta_alpha),
                               rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(t.v.numpy(), np.asarray(j.v), rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("name,launches", [("sdca", 1), ("importance", 1),
                                           ("accelerated", 4)])
def test_solver_launch_pattern_and_default_draws(name, launches, monkeypatch):
    arrays = [torch.from_numpy(a) for a in _inputs(4, 32, 64, "ridge")]
    calls = []
    real = ops.sdca_epoch

    def recording(*args, **kwargs):
        calls.append(args[8].shape)  # the visit orders
        return real(*args, **kwargs)

    monkeypatch.setattr(ops, "sdca_epoch", recording)
    solver = tsolvers.get_solver(name)
    runs = [solver(*arrays, 1e-3, 128, 2.0, [None] * 4, TorchDraws(seed), loss="ridge",
                   num_steps=40) for seed in (1, 1, 2)]
    per_launch = 40 // launches
    assert calls == [(4, per_launch)] * (3 * launches)  # all K workers a launch
    assert torch.equal(runs[0].v, runs[1].v) and not torch.equal(runs[0].v, runs[2].v)


def test_importance_draws_follow_the_weights():
    # Rows with larger norms are drawn more often.
    arrays = [torch.from_numpy(a) for a in _inputs(2, 32, 64, "ridge")]
    norms = arrays[4]
    seen = []

    class Recording(TorchDraws):
        def choice(self, keys, n, num, p):
            out = super().choice(keys, n, num, p)
            seen.append((p, out))
            return out

    tsolvers.solve_subproblem_importance(*arrays, 1e-3, 64, 50.0, [None] * 2,
                                         Recording(3), loss="ridge", num_steps=4000)
    p, idx = seen[0]
    torch.testing.assert_close(p.sum(-1), torch.ones(2))
    q = 1.0 + 50.0 * norms / (1e-3 * 64)
    torch.testing.assert_close(p, q / q.sum(-1, keepdim=True))
    heavy = norms[0] > norms[0].median()
    assert heavy[idx[0].long()].float().mean() > 0.6
