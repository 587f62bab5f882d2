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
"""

from __future__ import annotations

import torch

from repro_torch.core.objectives import LossName, _full_fp32, lam_n_f32
from repro_torch.core.sdca import (LocalSolveResult, as_orders,
                                   solve_subproblem_all_indices)


def solve_subproblem_sdca(w_all, alpha, X, y, norms_sq, lam: float, n_global: int,
                          sigma_prime: float, keys, draws, *, loss: LossName,
                          num_steps: int) -> LocalSolveResult:
    """H sequential SDCA steps with uniform sampling, every worker of the batch."""
    idx = as_orders(draws.randint(keys, X.shape[1], num_steps), X.device)
    return solve_subproblem_all_indices(w_all, alpha, X, y, norms_sq, lam,
                                        n_global, sigma_prime, idx, loss=loss)


def solve_subproblem_importance(w_all, alpha, X, y, norms_sq, lam: float,
                                n_global: int, sigma_prime: float, keys, draws, *,
                                loss: LossName, num_steps: int) -> LocalSolveResult:
    """SDCA with smoothness-proportional (importance) sampling."""
    q = 1.0 + sigma_prime * norms_sq / lam_n_f32(lam, n_global)
    p = q / torch.sum(q, dim=-1, keepdim=True)
    idx = as_orders(draws.choice(keys, X.shape[1], num_steps, p), X.device)
    return solve_subproblem_all_indices(w_all, alpha, X, y, norms_sq, lam,
                                        n_global, sigma_prime, idx, loss=loss)


def solve_subproblem_accelerated(w_all, alpha, X, y, norms_sq, lam: float,
                                 n_global: int, sigma_prime: float, keys, draws, *,
                                 loss: LossName, num_steps: int, num_rounds: int = 4,
                                 beta: float = 0.5) -> LocalSolveResult:
    """Catalyst-style accelerated SDCA: extrapolated restarts of the inner
    solver. Total coordinate steps = num_steps (split across rounds), so the
    comparison against plain SDCA is work-normalized."""
    n_k = X.shape[1]
    inner = max(1, num_steps // num_rounds)
    round_keys = [draws.split(key, num_rounds) for key in keys]  # (K, num_rounds)
    dalpha_prev = torch.zeros_like(alpha)
    dalpha = torch.zeros_like(alpha)
    v = torch.zeros_like(w_all)
    for r in range(num_rounds):
        momentum = beta * (dalpha - dalpha_prev)  # extrapolate in the dual
        da_y = dalpha + momentum
        with _full_fp32():
            v_y = v + torch.einsum("knd,kn->kd", X, momentum) / lam_n_f32(lam, n_global)
        idx = as_orders(draws.randint([ks[r] for ks in round_keys], n_k, inner),
                        X.device)
        res = solve_subproblem_all_indices(
            w_all + sigma_prime * v_y, alpha + da_y, X, y, norms_sq, lam, n_global,
            sigma_prime, idx, loss=loss)
        dalpha_prev, dalpha, v = dalpha, da_y + res.delta_alpha, v_y + res.v
    return LocalSolveResult(dalpha, v)


# ---------------------------------------------------------------------------
# Local-solver registry. The CoCoA-lineage protocols of
# repro_torch.core.engine ("cocoa" / "cocoa_plus") draw their per-worker
# subproblem solver from here by ``MethodConfig.local_solver``.
# ---------------------------------------------------------------------------

_SOLVERS = {}


def register_solver(name: str):
    """Decorator (usable as a plain call too): add a local solver under
    ``name``, the extension pattern of the protocol/compressor/delay
    registries."""

    def deco(fn):
        _SOLVERS[name] = fn
        return fn

    return deco


register_solver("sdca")(solve_subproblem_sdca)
register_solver("importance")(solve_subproblem_importance)
register_solver("accelerated")(solve_subproblem_accelerated)


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
