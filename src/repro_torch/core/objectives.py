"""Primal/dual objectives for l2-regularized empirical risk minimization.

PyTorch counterpart of ``repro.core.objectives``. The paper (ACPD, Huo &
Huang 2019) optimizes

    P(w) = (1/n) sum_i phi_i(w^T x_i) + (lambda/2) ||w||^2          (Eq. 2)

through its Fenchel dual

    D(alpha) = (1/n) sum_i -phi_i*(-alpha_i) - (lambda/2) || (1/(lambda n)) A alpha ||^2   (Eq. 3)

with the primal-dual map ``w(alpha) = (1/(lambda n)) A alpha`` (Eq. 5) and the
duality gap ``G(alpha) = P(w(alpha)) - D(alpha)`` as the convergence monitor.

Losses: ``ridge`` (the paper's experiments, Eq. 25), ``smoothed_hinge`` and
``logistic``. Layout: ``X (K, n_k, d)``, ``y (K, n_k)``, ``alpha (K, n_k)``.

The large products are ``torch.einsum`` calls, as the JAX package leaves them
to XLA. They run in full float32: :func:`_full_fp32` turns TF32 off for the
duration of each product instead of trusting the process-wide default.
"""

from __future__ import annotations

import contextlib
import dataclasses
from typing import Literal

import torch

LossName = Literal["ridge", "smoothed_hinge", "logistic"]

# Smoothing constant for the smoothed hinge; phi is (1/mu)-smooth with
# mu == _HINGE_SMOOTHING.
_HINGE_SMOOTHING = 1.0


@dataclasses.dataclass(frozen=True)
class Problem:
    """An l2-regularized ERM instance partitioned over K workers.

    Attributes:
      X: (K, n_k, d) stacked feature partitions (rows are samples).
      y: (K, n_k) labels; +-1 for classification losses, real for ridge.
      lam: l2 regularization strength (lambda in the paper).
      loss: which phi to use.
    """

    X: torch.Tensor
    y: torch.Tensor
    lam: float
    loss: LossName = "ridge"

    @property
    def num_workers(self) -> int:
        return self.X.shape[0]

    @property
    def n_per_worker(self) -> int:
        return self.X.shape[1]

    @property
    def n(self) -> int:
        return self.X.shape[0] * self.X.shape[1]

    @property
    def d(self) -> int:
        return self.X.shape[2]

    def global_X(self) -> torch.Tensor:
        return self.X.reshape(self.n, self.d)

    def global_y(self) -> torch.Tensor:
        return self.y.reshape(self.n)


def lam_n_f32(lam: float, n: int) -> float:
    """lambda * n as the JAX reference rounds it: a float32 product."""
    return float(torch.tensor(lam, dtype=torch.float32)
                 * torch.tensor(float(n), dtype=torch.float32))


@contextlib.contextmanager
def _full_fp32():
    """Run float32 matrix products in IEEE float32, never TF32."""
    prev = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = prev


# ---------------------------------------------------------------------------
# phi and phi* for each loss (conventions as in the JAX package).
# ---------------------------------------------------------------------------


def phi(loss: LossName, z: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """Pointwise loss phi_i(z) with label y_i."""
    if loss == "ridge":
        return 0.5 * (z - y) ** 2
    if loss == "smoothed_hinge":
        g = _HINGE_SMOOTHING
        m = y * z
        zero = torch.zeros_like(m)
        return torch.where(
            m >= 1.0, zero,
            torch.where(m <= 1.0 - g, 1.0 - m - 0.5 * g,
                        (1.0 - m) ** 2 / (2.0 * g)))
    if loss == "logistic":
        return torch.logaddexp(torch.zeros_like(z), -y * z)
    raise ValueError(f"unknown loss {loss!r}")


def neg_conj(loss: LossName, alpha: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """-phi_i*(-alpha_i): the per-sample term of the dual objective (Eq. 3)."""
    if loss == "ridge":
        return alpha * y - 0.5 * alpha**2
    neg_inf = torch.full_like(alpha, -torch.inf)
    if loss == "smoothed_hinge":
        g = _HINGE_SMOOTHING
        a = y * alpha
        feasible = (a >= 0.0) & (a <= 1.0)
        return torch.where(feasible, a - 0.5 * g * a**2, neg_inf)
    if loss == "logistic":
        eps = 1e-12
        a = torch.clamp(y * alpha, eps, 1.0 - eps)
        ent = -(a * torch.log(a) + (1.0 - a) * torch.log1p(-a))
        feasible = (y * alpha > 0.0) & (y * alpha < 1.0)
        return torch.where(feasible, ent, neg_inf)
    raise ValueError(f"unknown loss {loss!r}")


def dual_feasible_direction(loss: LossName, z: torch.Tensor,
                            y: torch.Tensor) -> torch.Tensor:
    """u_i with -u_i in d phi_i(z_i); used by the gap analysis and tests."""
    if loss == "ridge":
        return -(z - y)
    if loss == "smoothed_hinge":
        g = _HINGE_SMOOTHING
        m = y * z
        grad = torch.where(
            m >= 1.0, torch.zeros_like(m),
            torch.where(m <= 1.0 - g, torch.full_like(m, -1.0), (m - 1.0) / g)) * y
        return -grad
    if loss == "logistic":
        return y * torch.sigmoid(-y * z)
    raise ValueError(f"unknown loss {loss!r}")


def smoothness_mu(loss: LossName) -> float:
    """phi is (1/mu)-smooth; returns mu (strong-convexity constant of phi*)."""
    if loss == "ridge":
        return 1.0
    if loss == "smoothed_hinge":
        return _HINGE_SMOOTHING
    if loss == "logistic":
        return 4.0
    raise ValueError(f"unknown loss {loss!r}")


# ---------------------------------------------------------------------------
# Objectives.
# ---------------------------------------------------------------------------


def primal_objective(w: torch.Tensor, X: torch.Tensor, y: torch.Tensor,
                     lam: float, *, loss: LossName) -> torch.Tensor:
    """P(w) over stacked partitions X:(K,n_k,d), y:(K,n_k)."""
    with _full_fp32():
        z = torch.einsum("knd,d->kn", X, w)
    n = z.numel()
    return torch.sum(phi(loss, z, y)) / n + 0.5 * lam * torch.dot(w, w)


def dual_objective(alpha: torch.Tensor, X: torch.Tensor, y: torch.Tensor,
                   lam: float, *, loss: LossName) -> torch.Tensor:
    """D(alpha) over stacked partitions, alpha:(K,n_k)."""
    n = alpha.numel()
    w_alpha = primal_from_dual(alpha, X, lam)
    return (torch.sum(neg_conj(loss, alpha, y)) / n
            - 0.5 * lam * torch.dot(w_alpha, w_alpha))


def primal_from_dual(alpha: torch.Tensor, X: torch.Tensor, lam: float) -> torch.Tensor:
    """w(alpha) = (1/(lambda n)) A alpha  (Eq. 5), A = [x_1 .. x_n] in R^{d x n}."""
    n = alpha.numel()
    with _full_fp32():
        return torch.einsum("knd,kn->d", X, alpha) / lam_n_f32(lam, n)


def duality_gap(alpha: torch.Tensor, X: torch.Tensor, y: torch.Tensor,
                lam: float, *, loss: LossName) -> torch.Tensor:
    """G(alpha) = P(w(alpha)) - D(alpha) >= 0; the paper's convergence monitor."""
    w_alpha = primal_from_dual(alpha, X, lam)
    return (primal_objective(w_alpha, X, y, lam, loss=loss)
            - dual_objective(alpha, X, y, lam, loss=loss))


def gap_certificate(problem: Problem, alpha: torch.Tensor,
                    w: torch.Tensor | None = None) -> dict[str, float]:
    """All monitored quantities for logging/benchmarks, as host floats.

    If ``w`` (e.g. the server's sparsified model) is given, also reports
    P(w_server) - D(alpha), which is what a deployed system would monitor when
    the exact primal-dual relation is broken by the practical filter variant.
    """
    X, y, lam, loss = problem.X, problem.y, problem.lam, problem.loss
    w_alpha = primal_from_dual(alpha, X, lam)
    p = primal_objective(w_alpha, X, y, lam, loss=loss)
    dv = dual_objective(alpha, X, y, lam, loss=loss)
    out = {"primal": float(p), "dual": float(dv), "gap": float(p - dv)}
    if w is not None:
        p_srv = primal_objective(w, X, y, lam, loss=loss)
        out["primal_server"] = float(p_srv)
        out["gap_server"] = float(p_srv - dv)
    return out
