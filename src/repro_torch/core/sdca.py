"""Local SDCA solver for the CoCoA+-style subproblem G_k^{sigma'} (Eq. 7-8).

PyTorch counterpart of ``repro.core.sdca``. Each worker k holds a partition
``X_k: (n_k, d)``, ``y_k: (n_k,)`` and, per round, runs ``H`` sequential
stochastic dual coordinate-ascent steps with ``w_eff = w_k + gamma *
dw_residual`` (Algorithm 2, line 4) held fixed. The accumulated local primal
delta ``v = (1/(lambda n)) A_k dalpha`` is carried through the loop so each
coordinate step sees the effective margin ``z_i = (w_eff + sigma' * v)^T x_i``.

Closed-form coordinate maximizers:

* ridge:           delta = (y_i - a_i - z_i) / (1 + q_i)
* smoothed hinge:  b* = clip((1 - y z + q_i a_y) / (g + q_i), 0, 1); delta = y (b* - a_y)
* logistic:        Newton on b = y*alpha in (0,1) (8 damped steps)

with ``a_i = alpha_i + dalpha_i`` and ``q_i = sigma' ||x_i||^2 / (lambda n)``.

Dispatch: the ridge step, which is the paper's, goes through
``kernels.ops.sdca_epoch``: the hand-written CUDA kernel for tensors on the
card, its plain PyTorch version for tensors on the CPU. The other two losses
run the plain loop below on the CPU; on the card they raise until the kernel
grows them (ROADMAP, queue B, "CUDA path for non-ridge losses").

Visit orders are explicit: ``*_indices`` functions take them, the others
draw them from a ``torch.Generator``. The JAX package draws them from
``jax.random``; the two streams differ, so tests hand both the same orders.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from repro_torch.core.objectives import _HINGE_SMOOTHING, LossName, lam_n_f32
from repro_torch.kernels import ops


class LocalSolveResult(NamedTuple):
    delta_alpha: torch.Tensor  # (n_k,) or (K, n_k): Delta alpha_[k]
    v: torch.Tensor  # (d,) or (K, d): (1/(lambda n)) A_k Delta alpha_[k]


def _coordinate_delta(loss: LossName, a: torch.Tensor, z: torch.Tensor,
                      y: torch.Tensor, q: torch.Tensor) -> torch.Tensor:
    """Closed-form/Newton maximizer of the 1-D coordinate subproblem."""
    if loss == "ridge":
        return (y - a - z) / (1.0 + q)
    if loss == "smoothed_hinge":
        g = _HINGE_SMOOTHING
        a_y = y * a
        b = torch.clamp((1.0 - y * z + q * a_y) / (g + q), 0.0, 1.0)
        return y * (b - a_y)
    if loss == "logistic":
        eps = 1e-6
        a_y = torch.clamp(y * a, eps, 1.0 - eps)
        b = a_y
        # Damped Newton on f'(b) = log((1-b)/b) - y z - q (b - a_y).
        for _ in range(8):
            fp = torch.log1p(-b) - torch.log(b) - y * z - q * (b - a_y)
            fpp = -1.0 / (b * (1.0 - b)) - q
            b = torch.clamp(b - fp / fpp, eps, 1.0 - eps)
        return y * (b - a_y)
    raise ValueError(f"unknown loss {loss!r}")


def sdca_epoch_plain(loss: LossName, w_eff, alpha, X, y, norms_sq, lam: float,
                     n_global: int, sigma_prime: float, idx) -> LocalSolveResult:
    """H sequential SDCA steps for a batch of K workers, in plain PyTorch.

    Shapes: ``w_eff (K, d)``, ``alpha, y, norms_sq (K, n_k)``, ``X (K, n_k,
    d)``, ``idx (K, H)``; the JAX package's ``vmap`` is the batch dimension.
    """
    K = X.shape[0]
    lam_n = lam_n_f32(lam, n_global)
    rows = torch.arange(K, device=X.device)
    dalpha = torch.zeros_like(alpha)
    v = torch.zeros_like(w_eff)
    for h in range(idx.shape[1]):
        i = idx[:, h].long()
        x_i = X[rows, i]  # (K, d)
        a_i = alpha[rows, i] + dalpha[rows, i]
        z_i = (w_eff * x_i).sum(-1) + sigma_prime * (v * x_i).sum(-1)
        q_i = sigma_prime * norms_sq[rows, i] / lam_n
        delta = _coordinate_delta(loss, a_i, z_i, y[rows, i], q_i)
        dalpha[rows, i] += delta
        v = v + (delta / lam_n)[:, None] * x_i
    return LocalSolveResult(dalpha, v)


def solve_subproblem_all_indices(w_all, alpha, X, y, norms_sq, lam: float,
                                 n_global: int, sigma_prime: float, idx, *,
                                 loss: LossName) -> LocalSolveResult:
    """All K workers at once with explicit visit orders ``idx (K, H)``."""
    if loss == "ridge":
        dalpha, v = ops.sdca_epoch(w_all, alpha, X, y, norms_sq, lam,
                                   n_global, sigma_prime, idx)
        return LocalSolveResult(dalpha, v)
    if X.is_cuda:
        raise NotImplementedError(
            f"the CUDA SDCA kernel computes the ridge step only; loss "
            f"{loss!r} on the card waits for ROADMAP queue B, 'CUDA path for "
            f"non-ridge losses' (pass device='cpu' to run it on the host)")
    return sdca_epoch_plain(loss, w_all, alpha, X, y, norms_sq, lam, n_global,
                            sigma_prime, idx)


def solve_subproblem_indices(w_eff, alpha, X, y, norms_sq, lam: float,
                             n_global: int, sigma_prime: float, idx, *,
                             loss: LossName) -> LocalSolveResult:
    """H sequential SDCA steps on one worker with an explicit visit order.

    Shapes: ``w_eff (d,)``, ``alpha, y, norms_sq (n_k,)``, ``X (n_k, d)``,
    ``idx (H,)`` int32. On the card this is one kernel launch of one block.
    """
    res = solve_subproblem_all_indices(
        w_eff[None], alpha[None], X[None], y[None], norms_sq[None], lam,
        n_global, sigma_prime, idx[None], loss=loss)
    return LocalSolveResult(res.delta_alpha[0], res.v[0])


def draw_visit_order(n_k: int, num_steps: int, generator: torch.Generator,
                     *, batch: tuple[int, ...] = ()) -> torch.Tensor:
    """Uniform int32 coordinate indices in [0, n_k) on the generator's device."""
    return torch.randint(0, n_k, (*batch, num_steps), generator=generator,
                         device=generator.device, dtype=torch.int32)


def solve_subproblem(w_eff, alpha, X, y, norms_sq, lam: float, n_global: int,
                     sigma_prime: float, generator: torch.Generator, *,
                     loss: LossName, num_steps: int) -> LocalSolveResult:
    """H sequential SDCA steps with uniform sampling (Alg. 2 line 4)."""
    idx = draw_visit_order(X.shape[0], num_steps, generator).to(X.device)
    return solve_subproblem_indices(w_eff, alpha, X, y, norms_sq, lam,
                                    n_global, sigma_prime, idx, loss=loss)


def solve_subproblem_all(w_all, alpha, X, y, norms_sq, lam: float,
                         n_global: int, sigma_prime: float,
                         generator: torch.Generator, *, loss: LossName,
                         num_steps: int) -> LocalSolveResult:
    """All K workers solve simultaneously, one visit order each."""
    idx = draw_visit_order(X.shape[1], num_steps, generator,
                           batch=(X.shape[0],)).to(X.device)
    return solve_subproblem_all_indices(w_all, alpha, X, y, norms_sq, lam,
                                        n_global, sigma_prime, idx, loss=loss)


def sdca_reference_indices(X, y, lam: float, idx, *,
                           loss: LossName) -> tuple[torch.Tensor, torch.Tensor]:
    """Single-machine SDCA (SSZ'13) along the visit order ``idx``: (alpha, w).

    The K=1, sigma'=1, gamma=1 case with w maintained exactly via the
    primal-dual relation; the distributed methods converge to its optimum.
    Plain PyTorch on any device: it is the tests' oracle, not a worker step.
    """
    n, d = X.shape
    norms_sq = torch.sum(X * X, dim=-1)
    lam_n = lam_n_f32(lam, n)
    alpha = torch.zeros(n, dtype=X.dtype, device=X.device)
    w = torch.zeros(d, dtype=X.dtype, device=X.device)
    for i in idx.long():
        x_i = X[i]
        delta = _coordinate_delta(loss, alpha[i], torch.dot(w, x_i), y[i],
                                  norms_sq[i] / lam_n)
        alpha[i] += delta
        w = w + (delta / lam_n) * x_i
    return alpha, w


def sdca_reference(X, y, lam: float, generator: torch.Generator, *,
                   loss: LossName, num_epochs: int) -> tuple[torch.Tensor, torch.Tensor]:
    """:func:`sdca_reference_indices` along ``num_epochs * n`` uniform draws."""
    n = X.shape[0]
    idx = draw_visit_order(n, num_epochs * n, generator).to(X.device)
    return sdca_reference_indices(X, y, lam, idx, loss=loss)
