"""ACPD: straggler-agnostic server (Alg. 1) + bandwidth-efficient workers (Alg. 2).

PyTorch counterpart of the reference loops of ``repro.core.acpd``: an
event-driven simulation of the parameter-server protocol, with per-worker
stale models, group-wise B-of-K arrivals ordered by a simulated straggler
clock, the ``T``-periodic full synchronization that bounds staleness, the
top-``rho d`` message filter with residual feedback, and the per-worker
catch-up buffers ``dw_tilde_k`` on the server (``protocol="group"``); and the
synchronous CoCoA/CoCoA+/DisDCA baseline timed as an MPI ``allreduce``
(``protocol="sync"``).

The event loop is host Python; the tensor math runs on the problem's device.
On the card every ridge worker step is one launch of the CUDA SDCA kernel: a
batch of one worker for a group round, of all K workers for a sync round.

Visit orders: the loops consume one ``(H,)`` int32 order per worker round
from ``visit_orders`` (for ``sync``, K per round, worker 0 first). The
default source draws them from a ``torch.Generator`` seeded by ``seed``;
tests pass a source that replays the JAX package's key chain, so that both
packages walk the same coordinates.

The protocol engine (``repro.core.engine``) is not ported yet, so this module
has no ``run_method``; ``run_method_reference`` is the entry point.
"""

from __future__ import annotations

import dataclasses
import heapq
from typing import Any, Iterator

import numpy as np
import torch

from repro_torch.core import filter as msg_filter
from repro_torch.core import objectives
from repro_torch.core.sdca import (draw_visit_order, solve_subproblem_all_indices,
                                   solve_subproblem_indices)
from repro_torch.core.simulate import ClusterModel
from repro_torch.device import resolve_device


@dataclasses.dataclass(frozen=True)
class MethodConfig:
    """One distributed primal-dual method, in the paper's parameterization.

    The fields are those of ``repro.core.acpd.MethodConfig``, so configs
    carry over unchanged; the reference loops here read ``protocol``, ``B``,
    ``T``, ``rho``, ``gamma``, ``H``, ``sigma_prime``, ``use_exact_k`` and
    ``exact_dual_feedback``. The rest belong to the engine's protocols.
    """

    name: str
    protocol: str = "group"  # "group" or "sync" until the engine is ported
    B: int = 2  # group size: server proceeds once B workers arrived
    T: int = 20  # full-sync period; bounds staleness tau <= T-1
    rho: float = 1.0  # fraction of coordinates sent (1.0 = dense)
    gamma: float = 1.0  # server step size
    H: int = 1000  # local SDCA iterations per round
    sigma_prime: float | None = None  # None -> the protocol's default
    use_exact_k: bool = True  # exact top-k vs >= threshold (ties pass)
    compressor: str | None = None
    # Alg. 2 lines 10-12 exactly: put the filtered-out mass back into the
    # DUAL via dalpha_hat = lam*n*A^+ (dw o ~M), one host least-squares solve
    # per round (the paper calls it impractical and uses the primal residual).
    exact_dual_feedback: bool = False
    lag_xi: float = 1.0
    lag_window: int = 10
    local_solver: str = "sdca"
    adaptive_quantile: float = 0.5
    adaptive_ewma: float = 0.25
    b_min: int = 1
    n_chunks: int = 1
    pw_quantum: float | None = None
    n_racks: int = 2
    rack_b: int = 1

    def resolved_sigma_prime(self, K: int) -> float:
        """sigma' when unset: gamma*B for ``group``, gamma*K for ``sync``.

        These are the JAX engine's ``default_sigma_prime`` for the two
        protocols; the other protocols come with the engine.
        """
        if self.sigma_prime is not None:
            return self.sigma_prime
        if self.protocol == "group":
            return self.gamma * self.B
        if self.protocol == "sync":
            return self.gamma * K
        raise ValueError(
            f"protocol {self.protocol!r} has no sigma' default in the port "
            f"yet; only 'group' and 'sync' run here (ROADMAP item A6)")


def acpd_config(K: int, *, B: int | None = None, T: int = 20, rho_d: int | None = None,
                d: int | None = None, gamma: float = 0.5, H: int = 1000) -> MethodConfig:
    """Paper defaults: B=K/2, T=20, rho*d=1e3 (Sec. V-B)."""
    B = B if B is not None else max(1, K // 2)
    rho = 1.0 if (rho_d is None or d is None) else min(1.0, rho_d / d)
    return MethodConfig(name="ACPD", protocol="group", B=B, T=T, rho=rho, gamma=gamma, H=H)


@dataclasses.dataclass
class RunRecord:
    iteration: int
    sim_time: float
    gap: float
    gap_server: float
    primal: float
    dual: float
    bytes_up: int
    bytes_down: int
    compute_time: float
    comm_time: float


@dataclasses.dataclass
class RunResult:
    method: MethodConfig
    records: list[RunRecord]
    w: np.ndarray
    alpha: np.ndarray  # worker-canonical duals (may lead the server in-flight)
    alpha_applied: np.ndarray | None = None  # server-visible duals

    def time_to_gap(self, target: float) -> float | None:
        for r in self.records:
            if r.gap <= target:
                return r.sim_time
        return None

    def rounds_to_gap(self, target: float) -> int | None:
        for r in self.records:
            if r.gap <= target:
                return r.iteration
        return None

    def as_dict(self) -> dict[str, Any]:
        return {
            "method": self.method.name,
            "records": [dataclasses.asdict(r) for r in self.records],
        }


class _Message:
    """An in-flight worker->server message: F(dw_k) plus bookkeeping."""

    __slots__ = ("arrival", "worker", "payload", "alpha_snapshot", "nbytes", "seq")

    def __init__(self, arrival: float, worker: int, payload: torch.Tensor,
                 alpha_snapshot: torch.Tensor, nbytes: int, seq: int):
        self.arrival = arrival
        self.worker = worker
        self.payload = payload
        self.alpha_snapshot = alpha_snapshot
        self.nbytes = nbytes
        self.seq = seq

    def __lt__(self, other: "_Message") -> bool:
        return (self.arrival, self.seq) < (other.arrival, other.seq)


def torch_visit_orders(n_k: int, H: int, seed: int,
                       device: torch.device) -> Iterator[torch.Tensor]:
    """The default visit-order source: uniform draws from a seeded generator."""
    generator = torch.Generator(device=device)
    generator.manual_seed(seed)
    while True:
        yield draw_visit_order(n_k, H, generator)


def run_method_reference(
    problem: objectives.Problem,
    method: MethodConfig,
    cluster: ClusterModel,
    *,
    num_outer: int,
    seed: int = 0,
    eval_every: int = 1,
    visit_orders: Iterator[Any] | None = None,
    device: str | torch.device | None = None,
) -> RunResult:
    """Run ``method`` with the reference loops (one dispatch per op).

    ``device`` is where the run computes (CUDA unless given); the problem must
    already live there. ``visit_orders`` yields each worker round's ``(H,)``
    int32 order, as a tensor or an array, in the order the loop consumes
    them; by default they are drawn by :func:`torch_visit_orders`.
    """
    dev = resolve_device(device)
    if problem.X.device != dev:
        raise ValueError(f"the problem lives on {problem.X.device}, the run was "
                         f"asked for {dev}; build the problem on {dev}")
    if visit_orders is None:
        visit_orders = torch_visit_orders(problem.n_per_worker, method.H, seed,
                                          problem.X.device)
    if method.protocol == "sync":
        return _run_sync(problem, method, cluster, num_outer=num_outer, seed=seed,
                         eval_every=eval_every, visit_orders=visit_orders)
    if method.protocol == "group":
        return _run_group(problem, method, cluster, num_outer=num_outer, seed=seed,
                          eval_every=eval_every, visit_orders=visit_orders)
    raise ValueError(
        f"the reference loops cover 'group' and 'sync', got "
        f"{method.protocol!r}; the engine's protocols come with ROADMAP item A6")


def _next_order(visit_orders, device: torch.device) -> torch.Tensor:
    order = next(visit_orders)
    if not isinstance(order, torch.Tensor):  # a host array, maybe read-only
        order = torch.from_numpy(np.array(order, dtype=np.int32))
    return order.to(device=device, dtype=torch.int32)


# ---------------------------------------------------------------------------
# Reference group-wise protocol: Algorithms 1 + 2.
# ---------------------------------------------------------------------------


def _run_group(problem, method, cluster, *, num_outer, seed, eval_every,
               visit_orders) -> RunResult:
    K, n_k, d = problem.X.shape
    n = K * n_k
    lam, loss = problem.lam, problem.loss
    dev, dtype = problem.X.device, problem.X.dtype
    gamma = method.gamma
    sigma_p = method.resolved_sigma_prime(K)
    k_keep = msg_filter.num_kept(d, method.rho)
    dense = method.rho >= 1.0
    filt = msg_filter.topk_mask_exact if method.use_exact_k else msg_filter.topk_mask

    rng = np.random.default_rng(seed)
    norms_sq = torch.sum(problem.X * problem.X, dim=-1)

    # Server state (Alg. 1). The port updates its buffers in place.
    w_server = torch.zeros((d,), dtype=dtype, device=dev)
    dw_tilde = torch.zeros((K, d), dtype=dtype, device=dev)  # catch-up buffers

    # Worker state (Alg. 2).
    w_local = torch.zeros((K, d), dtype=dtype, device=dev)
    alpha = torch.zeros((K, n_k), dtype=dtype, device=dev)  # worker-canonical
    alpha_applied = torch.zeros((K, n_k), dtype=dtype, device=dev)  # server-visible
    residual = torch.zeros((K, d), dtype=dtype, device=dev)  # dw_k kept after filtering

    bytes_up = bytes_down = 0
    compute_time = comm_time = 0.0
    seq = 0
    queue: list[_Message] = []
    records: list[RunRecord] = []

    def _worker_round(k: int, start_time: float) -> _Message:
        """Run one full local round on worker k starting at ``start_time``."""
        nonlocal bytes_up, compute_time, comm_time, seq
        idx = _next_order(visit_orders, dev)
        w_eff = w_local[k] + gamma * residual[k]
        dalpha, v = solve_subproblem_indices(
            w_eff, alpha[k], problem.X[k], problem.y[k], norms_sq[k],
            lam, n, sigma_p, idx, loss=loss)
        alpha[k] += gamma * dalpha  # line 5
        dw = residual[k] + v  # line 6
        if dense:
            sent, new_residual = dw, torch.zeros_like(dw)
            nbytes = msg_filter.dense_bytes(d)
        else:
            res = filt(dw, k_keep)
            sent, new_residual = res.sent, res.residual  # practical variant
            nbytes = msg_filter.message_bytes(k_keep)
            if method.exact_dual_feedback:
                # Lines 10-12 exactly: unwind the unsent mass into the dual.
                # dalpha_hat = lam*n * A_[k]^+ (dw o ~M); A_[k] = X_k^T (d,n_k)
                unsent = new_residual.cpu().numpy().astype(np.float64)
                A = problem.X[k].cpu().numpy().astype(np.float64).T  # (d, n_k)
                dalpha_hat, *_ = np.linalg.lstsq(A, lam * n * unsent, rcond=None)
                alpha[k] += -gamma * torch.as_tensor(dalpha_hat, dtype=dtype,
                                                     device=dev)  # line 11
                new_residual = torch.zeros_like(dw)  # line 12
        residual[k] = new_residual

        duration = cluster.compute_time(k, method.H, rng)
        up_time = cluster.p2p_time(nbytes)
        compute_time += duration
        comm_time += up_time
        bytes_up += nbytes
        arrival = start_time + duration + up_time
        seq += 1
        return _Message(arrival, k, sent, alpha[k].clone(), nbytes, seq)

    # All workers start their first round at t=0.
    for k in range(K):
        heapq.heappush(queue, _worker_round(k, 0.0))

    iteration = 0
    for _ in range(num_outer):
        for t in range(method.T):
            full_sync = t == method.T - 1
            need = K if full_sync else min(method.B, K)
            arrived: list[_Message] = [heapq.heappop(queue) for _ in range(need)]
            server_time = max(m.arrival for m in arrived)

            # Alg. 1 lines 8/10: accumulate gamma * F into every catch-up
            # buffer and into the global model.
            total = torch.zeros((d,), dtype=dtype, device=dev)
            for m in arrived:
                total = total + m.payload
                alpha_applied[m.worker] = m.alpha_snapshot
            w_server += gamma * total
            dw_tilde += gamma * total[None, :]

            # Alg. 1 line 11: reply with dw_tilde_k, zero it; worker applies
            # (Alg. 2 lines 13-14) and starts its next round.
            for m in arrived:
                k = m.worker
                reply = dw_tilde[k]
                reply_nnz = int(msg_filter.nnz(reply))
                rbytes = (msg_filter.message_bytes(reply_nnz) if not dense
                          else msg_filter.dense_bytes(d))
                bytes_down += rbytes
                down_time = cluster.p2p_time(rbytes)
                comm_time += down_time
                w_local[k] += reply
                dw_tilde[k] = 0.0
                heapq.heappush(queue, _worker_round(k, server_time + down_time))

            iteration += 1
            if iteration % eval_every == 0:
                cert = objectives.gap_certificate(problem, alpha_applied, w=w_server)
                records.append(RunRecord(
                    iteration=iteration, sim_time=server_time,
                    gap=cert["gap"], gap_server=cert["gap_server"],
                    primal=cert["primal"], dual=cert["dual"],
                    bytes_up=bytes_up, bytes_down=bytes_down,
                    compute_time=compute_time, comm_time=comm_time,
                ))

    return RunResult(method, records, w_server.cpu().numpy(), alpha.cpu().numpy(),
                     alpha_applied=alpha_applied.cpu().numpy())


# ---------------------------------------------------------------------------
# Synchronous protocol: CoCoA / CoCoA+ / DisDCA (allreduce-timed).
# ---------------------------------------------------------------------------


def _run_sync(problem, method, cluster, *, num_outer, seed, eval_every,
              visit_orders) -> RunResult:
    K, n_k, d = problem.X.shape
    n = K * n_k
    lam, loss = problem.lam, problem.loss
    dev, dtype = problem.X.device, problem.X.dtype
    gamma = method.gamma
    sigma_p = method.resolved_sigma_prime(K)

    rng = np.random.default_rng(seed)
    norms_sq = torch.sum(problem.X * problem.X, dim=-1)

    w = torch.zeros((d,), dtype=dtype, device=dev)
    alpha = torch.zeros((K, n_k), dtype=dtype, device=dev)

    sim_time = 0.0
    bytes_up = bytes_down = 0
    compute_time = comm_time = 0.0
    records: list[RunRecord] = []

    for it in range(1, num_outer + 1):
        idx = torch.stack([_next_order(visit_orders, dev) for _ in range(K)])
        w_all = w.expand(K, d).contiguous()
        dalpha, v = solve_subproblem_all_indices(
            w_all, alpha, problem.X, problem.y, norms_sq, lam, n, sigma_p, idx,
            loss=loss)
        alpha = alpha + gamma * dalpha
        w = w + gamma * torch.sum(v, dim=0)

        step_compute = max(cluster.compute_time(k, method.H, rng) for k in range(K))
        step_comm = cluster.allreduce_time(d)
        sim_time += step_compute + step_comm
        compute_time += step_compute
        comm_time += step_comm
        # Ring all-reduce = reduce-scatter + all-gather, (K-1)/K * d * 4 bytes
        # per node per phase: the first is billed as upload, the second as
        # download, like the group protocol's up/down accounting.
        phase = (K - 1) * d * 4
        bytes_up += phase
        bytes_down += phase

        if it % eval_every == 0:
            cert = objectives.gap_certificate(problem, alpha, w=w)
            records.append(RunRecord(
                iteration=it, sim_time=sim_time,
                gap=cert["gap"], gap_server=cert["gap_server"],
                primal=cert["primal"], dual=cert["dual"],
                bytes_up=bytes_up, bytes_down=bytes_down,
                compute_time=compute_time, comm_time=comm_time,
            ))

    return RunResult(method, records, w.cpu().numpy(), alpha.cpu().numpy())
