"""Alternative local solvers the paper points to (Sec. III-B1), as a registry.

PyTorch counterpart of ``repro.core.solvers``. The paper uses plain SDCA
with uniform sampling and lists two drop-in alternatives, both here on the
same subproblem interface:

* ``importance``: coordinates sampled with probability proportional to
  ``1 + sigma' ||x_i||^2 / (lambda n)`` (smoothness-proportional), the
  update unchanged;
* ``accelerated``: Catalyst-style restarts of the SDCA inner loop at
  extrapolated points ``y_t = alpha_t + beta (alpha_t - alpha_{t-1})``,
  ``num_steps`` coordinate steps in all, split over ``num_rounds`` rounds.

Every entry solves a batch of workers at once (the JAX package vmaps its
single-worker solver over the worker axis) and shares one signature::

    solver(w_all, alpha, X, y, norms_sq, lam, n_global, sigma_prime, keys,
           draws, *, loss, num_steps) -> LocalSolveResult

with ``w_all (K, d)``, ``alpha, y, norms_sq (K, n_k)``, ``X (K, n_k, d)``,
one key per worker and a draw source (``sdca.TorchDraws`` or a replay of the
JAX package's draws) that turns keys into visit orders: a uniform draw for
``sdca`` and for each round of ``accelerated``, a weighted draw for
``importance``. Every local solve goes through ``ops.sdca_epoch``, so on the
card ``sdca`` and ``importance`` are one launch of the SDCA kernel for all K
workers and ``accelerated`` is ``num_rounds`` launches. The extrapolation's
``X^T momentum`` is a batched product in float32, as in the JAX package
(outside any kernel).

The built-in entries are :class:`LocalSolver`\\ s, which split a call in
two: ``draw`` (the visit orders, from the draw source, in the call order of
the whole solver) and ``solve`` (the device work on given orders). The
whole-run executor draws a run's orders before the run and solves inside
it; ``solve`` also takes ``cells`` variants stacked as ``cells * K`` batch
rows over one shared ``X`` (a sweep's ``batch="vmap"``).
"""

from __future__ import annotations

from typing import Callable

import torch

from repro_torch.core.objectives import LossName, _full_fp32, lam_n_f32
from repro_torch.core.sdca import (LocalSolveResult, as_orders,
                                   solve_subproblem_all_indices)


class LocalSolver:
    """A local solver as its draws and its solve (see the module docstring).

    ``draw(keys, draws, *, n_k, num_steps, norms_sq, lam, n_global,
    sigma_prime, device)`` returns the list of int32 order tensors the solve
    consumes; ``solve(orders, w_all, alpha, X, y, norms_sq, lam, n_global,
    sigma_prime, *, loss, cells=1, map_error=None)`` runs on them. With
    ``cells`` V > 1, ``w_all`` and ``alpha`` hold ``V * K`` rows (variant
    major), ``sigma_prime`` is a ``(V * K,)`` float32 tensor, and each
    launch is one kernel launch of all the rows over the shared ``X``.
    """

    def __init__(self, draw: Callable, solve: Callable):
        self.draw = draw
        self.solve = solve

    def __call__(self, w_all, alpha, X, y, norms_sq, lam: float, n_global: int,
                 sigma_prime: float, keys, draws, *, loss: LossName,
                 num_steps: int) -> LocalSolveResult:
        orders = self.draw(keys, draws, n_k=X.shape[1], num_steps=num_steps,
                           norms_sq=norms_sq, lam=lam, n_global=n_global,
                           sigma_prime=sigma_prime, device=X.device)
        return self.solve(orders, w_all, alpha, X, y, norms_sq, lam, n_global,
                          sigma_prime, loss=loss)


def _rows(X, cells: int, sigma_prime, map_error) -> dict:
    """The kernel's row options for ``cells`` variants stacked over ``X``."""
    if cells == 1:
        return {}
    K = X.shape[0]
    workers = torch.arange(K, dtype=torch.int32, device=X.device).repeat(cells)
    return dict(workers=workers, map_error=map_error, alpha_rows=True,
                sigma_rows=sigma_prime)


def _solve_once(orders, w_all, alpha, X, y, norms_sq, lam, n_global, sigma_prime, *,
                loss, cells=1, map_error=None) -> LocalSolveResult:
    """One launch on the single order tensor of ``sdca`` / ``importance``."""
    return solve_subproblem_all_indices(w_all, alpha, X, y, norms_sq, lam, n_global,
                                        sigma_prime if cells == 1 else 0.0, orders[0],
                                        loss=loss, **_rows(X, cells, sigma_prime, map_error))


def _draw_uniform(keys, draws, *, n_k, num_steps, device, **_):
    return [as_orders(draws.randint(keys, n_k, num_steps), device)]


def _draw_importance(keys, draws, *, n_k, num_steps, norms_sq, lam, n_global,
                     sigma_prime, device):
    q = 1.0 + sigma_prime * norms_sq / lam_n_f32(lam, n_global)
    p = q / torch.sum(q, dim=-1, keepdim=True)
    return [as_orders(draws.choice(keys, n_k, num_steps, p), device)]


def solve_subproblem_sdca(w_all, alpha, X, y, norms_sq, lam: float, n_global: int,
                          sigma_prime: float, keys, draws, *, loss: LossName,
                          num_steps: int) -> LocalSolveResult:
    """H sequential SDCA steps with uniform sampling, every worker of the batch."""
    return SDCA(w_all, alpha, X, y, norms_sq, lam, n_global, sigma_prime, keys, draws,
                loss=loss, num_steps=num_steps)


def solve_subproblem_importance(w_all, alpha, X, y, norms_sq, lam: float,
                                n_global: int, sigma_prime: float, keys, draws, *,
                                loss: LossName, num_steps: int) -> LocalSolveResult:
    """SDCA with smoothness-proportional (importance) sampling."""
    return IMPORTANCE(w_all, alpha, X, y, norms_sq, lam, n_global, sigma_prime, keys,
                      draws, loss=loss, num_steps=num_steps)


ACCEL_ROUNDS, ACCEL_BETA = 4, 0.5


def _draw_accelerated(keys, draws, *, n_k, num_steps, device, num_rounds=ACCEL_ROUNDS,
                      **_):
    inner = max(1, num_steps // num_rounds)
    round_keys = [draws.split(key, num_rounds) for key in keys]  # (K, num_rounds)
    return [as_orders(draws.randint([ks[r] for ks in round_keys], n_k, inner), device)
            for r in range(num_rounds)]


def _solve_accelerated(orders, w_all, alpha, X, y, norms_sq, lam, n_global, sigma_prime,
                       *, loss, cells=1, map_error=None, beta=ACCEL_BETA):
    K, n_k, d = X.shape
    rows = _rows(X, cells, sigma_prime, map_error)
    sigma = sigma_prime if cells == 1 else sigma_prime[:, None]
    dalpha_prev = torch.zeros_like(alpha)
    dalpha = torch.zeros_like(alpha)
    v = torch.zeros_like(w_all)
    for idx in orders:
        momentum = beta * (dalpha - dalpha_prev)  # extrapolate in the dual
        da_y = dalpha + momentum
        with _full_fp32():
            if cells == 1:
                xm = torch.einsum("knd,kn->kd", X, momentum)
            else:
                xm = torch.einsum("knd,vkn->vkd", X,
                                  momentum.view(cells, K, n_k)).reshape(cells * K, d)
            v_y = v + xm / lam_n_f32(lam, n_global)
        res = solve_subproblem_all_indices(
            w_all + sigma * v_y, alpha + da_y, X, y, norms_sq, lam, n_global,
            sigma_prime if cells == 1 else 0.0, idx, loss=loss, **rows)
        dalpha_prev, dalpha, v = dalpha, da_y + res.delta_alpha, v_y + res.v
    return LocalSolveResult(dalpha, v)


def solve_subproblem_accelerated(w_all, alpha, X, y, norms_sq, lam: float,
                                 n_global: int, sigma_prime: float, keys, draws, *,
                                 loss: LossName, num_steps: int,
                                 num_rounds: int = ACCEL_ROUNDS,
                                 beta: float = ACCEL_BETA) -> LocalSolveResult:
    """Catalyst-style accelerated SDCA: extrapolated restarts of the inner
    solver. Total coordinate steps = num_steps (split across rounds), so the
    comparison against plain SDCA is work-normalized."""
    orders = _draw_accelerated(keys, draws, n_k=X.shape[1], num_steps=num_steps,
                               device=X.device, num_rounds=num_rounds)
    return _solve_accelerated(orders, w_all, alpha, X, y, norms_sq, lam, n_global,
                              sigma_prime, loss=loss, beta=beta)


SDCA = LocalSolver(_draw_uniform, _solve_once)
IMPORTANCE = LocalSolver(_draw_importance, _solve_once)
ACCELERATED = LocalSolver(_draw_accelerated, _solve_accelerated)

# ---------------------------------------------------------------------------
# Local-solver registry. The CoCoA-lineage protocols of
# repro_torch.core.engine ("cocoa" / "cocoa_plus") draw their per-worker
# subproblem solver from here by ``MethodConfig.local_solver``.
# ---------------------------------------------------------------------------

_SOLVERS = {}


def register_solver(name: str):
    """Decorator (usable as a plain call too): add a local solver under
    ``name``, the extension pattern of the protocol/compressor/delay
    registries. A plain function runs on the event engine; a
    :class:`LocalSolver` also runs on the whole-run executor."""

    def deco(fn):
        _SOLVERS[name] = fn
        return fn

    return deco


register_solver("sdca")(SDCA)
register_solver("importance")(IMPORTANCE)
register_solver("accelerated")(ACCELERATED)


def available_solvers() -> tuple[str, ...]:
    return tuple(sorted(_SOLVERS))


def get_solver(name: str):
    """Resolve a ``MethodConfig.local_solver`` name; ValueError lists the
    registry on a miss (the error contract of protocols/compressors)."""
    try:
        return _SOLVERS[name]
    except KeyError:
        raise ValueError(
            f"unknown local solver {name!r}; available: {available_solvers()}"
        ) from None
