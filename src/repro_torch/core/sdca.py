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

Dispatch: every loss goes through ``kernels.ops.sdca_epoch``: the
hand-written CUDA kernel for tensors on the card, the plain loop below
(``sdca_epoch_plain``) for tensors on the CPU.

Visit orders are explicit: ``*_indices`` functions take them, the others
draw them from a ``torch.Generator``, and the engine and the solver
registry draw them through a draw source (:class:`TorchDraws` by default,
:class:`StreamDraws` to walk the reference loops' stream). The JAX package
draws them from ``jax.random``; the two streams differ, so tests hand both
the same orders.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
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
                     n_global: int, sigma_prime: float, idx, workers=None, *,
                     alpha_rows: bool = False, sigma_rows=None) -> LocalSolveResult:
    """H sequential SDCA steps for a batch of workers, in plain PyTorch.

    Shapes: ``X (K, n_k, d)``, ``alpha, y, norms_sq (K, n_k)``; ``w_eff (B,
    d)`` and ``idx (B, H)``, one row per worker of the batch; the JAX
    package's ``vmap`` is the batch dimension. Batch row b is worker
    ``workers[b]`` (an int sequence or tensor, each entry in ``[0, K)`` or
    ``ValueError``), or worker b when ``workers`` is None (then B = K).
    ``alpha_rows`` reads ``alpha (B, n_k)`` at row b instead of at its
    worker; ``sigma_rows (B,)`` replaces ``sigma_prime`` row by row. A step
    whose index lies outside ``[0, n_k)`` is skipped for its worker, as the
    CUDA kernel skips it: it changes neither ``dalpha`` nor ``v``. Returns
    ``dalpha (B, n_k)`` and ``v (B, d)``.
    """
    K, n_k = X.shape[0], X.shape[1]
    lam_n = lam_n_f32(lam, n_global)
    B = idx.shape[0]
    batch = torch.arange(B, device=X.device)
    rows = batch if workers is None else torch.as_tensor(workers, device=X.device).long()
    if workers is not None and rows.numel() and (int(rows.min()) < 0 or int(rows.max()) >= K):
        bad = int(torch.nonzero((rows < 0) | (rows >= K))[0, 0])
        raise ValueError(f"sdca_inner: worker map entry {int(rows[bad])} of batch row "
                         f"{bad} lies outside [0, {K})")
    arows = batch if alpha_rows else rows
    sigma = sigma_prime if sigma_rows is None else sigma_rows
    dalpha = torch.zeros((B, n_k), dtype=alpha.dtype, device=alpha.device)
    v = torch.zeros_like(w_eff)
    for h in range(idx.shape[1]):
        step = idx[:, h].long()
        inside = (step >= 0) & (step < n_k)
        i = step.clamp(0, n_k - 1)
        x_i = X[rows, i]  # (B, d)
        a_i = alpha[arows, i] + dalpha[batch, i]
        z_i = (w_eff * x_i).sum(-1) + sigma * (v * x_i).sum(-1)
        q_i = sigma * norms_sq[rows, i] / lam_n
        delta = _coordinate_delta(loss, a_i, z_i, y[rows, i], q_i)
        delta = torch.where(inside, delta, torch.zeros_like(delta))
        dalpha[batch, i] += delta
        v = v + (delta / lam_n)[:, None] * x_i
    return LocalSolveResult(dalpha, v)


def solve_subproblem_all_indices(w_all, alpha, X, y, norms_sq, lam: float,
                                 n_global: int, sigma_prime: float, idx, *,
                                 loss: LossName, workers=None,
                                 **row_options) -> LocalSolveResult:
    """A batch of workers at once with explicit visit orders ``idx (B, H)``.

    ``workers`` maps batch row b to its worker (see :func:`sdca_epoch_plain`);
    without it the batch is all K workers. ``row_options`` are the kernel's
    ``map_error``, ``alpha_rows`` and ``sigma_rows`` (``ops.sdca_epoch``).
    On the card this is one launch.
    """
    dalpha, v = ops.sdca_epoch(w_all, alpha, X, y, norms_sq, lam, n_global,
                               sigma_prime, idx, loss=loss, workers=workers,
                               **row_options)
    return LocalSolveResult(dalpha, v)


def solve_subproblem_indices(w_eff, alpha, X, y, norms_sq, lam: float,
                             n_global: int, sigma_prime: float, idx, *,
                             loss: LossName) -> LocalSolveResult:
    """H sequential SDCA steps on one worker with an explicit visit order.

    Shapes: ``w_eff (d,)``, ``alpha, y, norms_sq (n_k,)``, ``X (n_k, d)``,
    ``idx (H,)`` int32. On the card this is one kernel launch of one cluster.
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


class TorchDraws:
    """The default source of the engine's random draws: one seeded generator.

    A draw source stands in for ``jax.random``'s key API wherever the JAX
    package draws on the device: ``root()`` makes the run's key, ``split(key,
    num)`` gives ``num`` sub-keys, and ``randint(keys, n, num)`` /
    ``choice(keys, n, num, p)`` give one row of ``num`` int32 draws in
    ``[0, n)`` for each key (``choice`` weighted by the rows of ``p``).
    Results may be tensors or arrays. Tests supply a source whose keys are JAX
    keys, replaying the JAX package's draws exactly; here the keys carry
    nothing and every draw comes from one ``torch.Generator`` in call order,
    so a run repeats for a given seed.
    """

    def __init__(self, seed: int, device: str | torch.device = "cpu"):
        self.generator = torch.Generator(device=device)
        self.generator.manual_seed(seed)

    def root(self):
        return None

    def split(self, key, num: int) -> list:
        return [None] * num

    def randint(self, keys, n: int, num: int) -> torch.Tensor:
        return draw_visit_order(n, num, self.generator, batch=(len(keys),))

    def choice(self, keys, n: int, num: int, p: torch.Tensor) -> torch.Tensor:
        p = p.to(self.generator.device)
        # A row of weights with a NaN or an inf, or that sums to zero (a
        # diverged cell's), draws uniformly: the cell runs on and is masked,
        # as the JAX package's is. Decided on the device, with no host sync.
        bad = (~torch.isfinite(p)).any(dim=-1, keepdim=True) | (
            p.sum(dim=-1, keepdim=True) <= 0)
        p = torch.where(bad, torch.ones_like(p), p)
        return torch.multinomial(p, num, replacement=True,
                                 generator=self.generator).to(torch.int32)

    def save(self, key) -> np.ndarray:
        """The source's position as an array (a checkpoint's ``key``)."""
        return self.generator.get_state().numpy().copy()

    def restore(self, state) -> None:
        """Resume at a position :meth:`save` returned; the next key is
        ``root()``'s."""
        self.generator.set_state(torch.as_tensor(np.asarray(state, dtype=np.uint8)))
        return self.root()


class StreamDraws(TorchDraws):
    """A draw source that hands out the orders of a visit-order stream.

    Each key of a ``randint`` call takes the stream's next ``(H,)`` order, so
    the engine walks exactly the orders that ``run_method_reference`` walks
    when given the same stream (for ``group``, one per worker round in launch
    order; for ``sync``, K a round, worker 0 first). A stream has no weighted
    draws, so ``choice`` raises.
    """

    def __init__(self, visit_orders):
        self.visit_orders = visit_orders

    def randint(self, keys, n: int, num: int):
        return torch.stack([torch.as_tensor(next(self.visit_orders)).to(torch.int32)
                            for _ in keys])

    def choice(self, keys, n: int, num: int, p):
        raise ValueError("a visit-order stream holds uniform orders only; weighted "
                         "draws need a source with choice() (TorchDraws)")

    def save(self, key):
        raise ValueError("a visit-order stream has no position to checkpoint; use "
                         "TorchDraws")

    restore = save


def as_orders(draws, device: torch.device) -> torch.Tensor:
    """A source's draws as a contiguous int32 tensor on ``device``."""
    if not isinstance(draws, torch.Tensor):  # a host array, maybe read-only
        draws = torch.from_numpy(np.array(draws, dtype=np.int32))
    return draws.to(device=device, dtype=torch.int32).contiguous()


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
