"""Pluggable event-driven protocol engine for distributed primal-dual methods.

PyTorch counterpart of ``repro.core.engine``. One priority-queue server
loop (:class:`repro_torch.api.session.Session`), parameterized by a
:class:`Protocol` that supplies three rules:

* **arrival rule**     -- how many worker messages a round waits for (B of K
  for ``group``, all K for the lockstep methods, 1 for ``async``, rack quotas
  for ``hierarchical_b``, chunk deadlines for ``partial_work``);
* **aggregation rule** -- how arrived payloads enter the server state
  (catch-up buffers ``dw_tilde`` for the group family, a plain sum for the
  CoCoA lineage);
* **reply rule**       -- what goes back to each worker, and how it is timed
  and billed.

Protocols are registry entries (:func:`register_protocol`) under the JAX
package's names: ``group``, ``sync``, ``async``, ``lag``, ``cocoa``,
``cocoa_plus``, ``adaptive_b``, ``partial_work`` and ``hierarchical_b``.

Device work, on the problem's device:

* a whole GROUP of worker rounds is ONE ``ops.sdca_epoch`` launch: the B
  relaunched workers solve against their own fixed ``w_local`` rows, so
  they are independent, and the kernel's worker map runs them as B clusters
  on their rows of ``X`` without copying them. A chunked pass
  (``partial_work``) is one launch per chunk for all its workers. The
  lockstep methods launch all K workers a round (``accelerated``: one
  launch per inner round);
* each server round is a few tensor ops, then one host pull of the replies'
  ``nnz`` for the byte accounting (none when replies are dense); ``lag``
  adds one pull of its skip flags per group;
* duality-gap evaluation is deferred: ``(w, alpha)`` snapshots are kept
  during the loop and scored after it (:func:`_materialize_records`), in
  ``batched`` mode by two float32 products over ``X`` for all snapshots at
  once, in ``replay`` mode by one ``gap_certificate`` each.

Randomness: host draws (delays) come from ``np.random.default_rng(seed)``
exactly as in the JAX package, so the accounting is equal; device draws
(visit orders, the solvers' samples) come from a draw source
(``sdca.TorchDraws`` by default) in the JAX package's key structure: one
``split`` per worker round in launch order, ``split(sub, K)`` per lockstep
round, worker-major per chunk. A source that replays ``jax.random`` makes
both packages walk the same coordinates.

The round bodies that the whole-run executor (:mod:`repro_torch.core.executor`)
runs too are defined once, below the evaluation: :func:`lockstep_round`,
:func:`group_local_rounds`, :func:`lag_skip`, :func:`aggregate` (and
:func:`aggregate_masked`), :func:`apply_snapshots`, :func:`reply` and
:func:`lag_window_append`. The
event engine calls them with index tensors built from its host queue, the
executor with the device's arrival order; the same ops on the same values
make the two backends equal bit for bit. ``Protocol.coalesce_supported`` is
the batching rule the serve layer will ask (ROADMAP A6).
"""

from __future__ import annotations

import dataclasses
import math
from typing import Iterable

import numpy as np
import torch

from repro_torch.core import compress as compress_lib
from repro_torch.core import filter as msg_filter
from repro_torch.core import objectives
from repro_torch.core import solvers as solvers_lib
from repro_torch.core.acpd import MethodConfig, RunRecord, RunResult
from repro_torch.core.objectives import _full_fp32, lam_n_f32
from repro_torch.core.sdca import TorchDraws, as_orders
from repro_torch.core.simulate import ClusterModel
from repro_torch.kernels import ops

# ---------------------------------------------------------------------------
# Protocol registry.
# ---------------------------------------------------------------------------

_PROTOCOLS: dict[str, type["Protocol"]] = {}


def register_protocol(name: str):
    """Class decorator: make a Protocol constructible via ``MethodConfig.protocol``."""

    def deco(cls: type["Protocol"]) -> type["Protocol"]:
        cls.protocol_name = name
        _PROTOCOLS[name] = cls
        return cls

    return deco


def available_protocols() -> tuple[str, ...]:
    return tuple(sorted(_PROTOCOLS))


def get_protocol(name: str) -> type["Protocol"]:
    try:
        return _PROTOCOLS[name]
    except KeyError:
        raise ValueError(
            f"unknown protocol {name!r}; available: {available_protocols()}"
        ) from None


# ---------------------------------------------------------------------------
# Messages and deferred evaluation records.
# ---------------------------------------------------------------------------


class Message:
    """An in-flight worker->server message (payload stays on the device)."""

    __slots__ = ("arrival", "worker", "payload", "alpha_snapshot", "nbytes",
                 "seq", "applied", "chunk", "final")

    def __init__(self, arrival: float, worker: int, payload, alpha_snapshot,
                 nbytes: int, seq: int, applied: bool = True,
                 chunk: int = 0, final: bool = True):
        self.arrival = arrival
        self.worker = worker
        self.payload = payload
        self.alpha_snapshot = alpha_snapshot
        self.nbytes = nbytes
        self.seq = seq
        self.applied = applied  # False for LAG heartbeats (skipped uploads)
        self.chunk = chunk  # chunk index within the sender's local pass
        self.final = final  # last chunk of the pass (non-chunked: always)

    def __lt__(self, other: "Message") -> bool:
        return (self.arrival, self.seq) < (other.arrival, other.seq)


@dataclasses.dataclass
class _Snapshot:
    """Host-side accounting + device state captured at an eval boundary.

    ``w`` and ``alpha`` are never written in place after a snapshot holds
    them: the protocols replace ``w_server``/``alpha_applied``/``w``/``alpha``
    with new tensors each round.
    """

    iteration: int
    sim_time: float
    bytes_up: int
    bytes_down: int
    compute_time: float
    comm_time: float
    w: torch.Tensor
    alpha: torch.Tensor  # (K, n_k) server-visible (group) / canonical (sync)


# ---------------------------------------------------------------------------
# Deferred evaluation.
# ---------------------------------------------------------------------------


def _bucket_size(count: int) -> int:
    """Next power of two >= count (the JAX package's padding rule for the
    sweeps' cell and eval axes)."""
    return 1 << max(0, count - 1).bit_length()


def _eval_batched(ws: torch.Tensor, alphas: torch.Tensor, problem: objectives.Problem):
    """Every snapshot's certificate from two float32 passes over ``X``.

    ``ws (S, d)`` server models, ``alphas (S, K, n_k)`` duals. First
    ``W_alpha = alphas X / (lambda n)`` for all S at once, then the margins
    ``X [W_alpha | W_server]^T`` (n, 2S); the rest is elementwise. Returns
    (primal, dual, gap, gap_server), each (S,). Within float32 rounding of
    :func:`objectives.gap_certificate` on each snapshot (the sums run in
    another order), not bit for bit.
    """
    X, y, lam, loss = problem.X, problem.y, problem.lam, problem.loss
    S = ws.shape[0]
    n, d = problem.n, problem.d
    Xg = X.reshape(n, d)
    A = alphas.reshape(S, n)
    with _full_fp32():
        w_alpha = (A @ Xg) / lam_n_f32(lam, n)
        W = torch.cat([w_alpha, ws])  # (2S, d)
        z = Xg @ W.T  # (n, 2S)
    primal = (objectives.phi(loss, z, problem.global_y()[:, None]).sum(0) / n
              + 0.5 * lam * (W * W).sum(-1))
    dual = (objectives.neg_conj(loss, A, problem.global_y()[None]).sum(-1) / n
            - 0.5 * lam * (w_alpha * w_alpha).sum(-1))
    p, p_srv = primal[:S], primal[S:]
    return p, dual, p - dual, p_srv - dual


def _materialize_records(snaps: list[_Snapshot], problem: objectives.Problem,
                         eval_mode: str) -> list[RunRecord]:
    """Turn deferred snapshots into RunRecords.

    ``batched``: :func:`_eval_batched` over all snapshots at once.
    ``replay``: one ``objectives.gap_certificate`` per snapshot, the ops of
    the reference loops' per-round certificates.
    """
    if not snaps:
        return []
    if eval_mode == "replay":
        rows = []
        for s in snaps:
            cert = objectives.gap_certificate(problem, s.alpha, w=s.w)
            rows.append((cert["primal"], cert["dual"], cert["gap"],
                         cert["gap_server"]))
    elif eval_mode == "batched":
        p, dv, gap, gap_srv = _eval_batched(torch.stack([s.w for s in snaps]),
                                            torch.stack([s.alpha for s in snaps]),
                                            problem)
        rows = list(zip(*(t.tolist() for t in (p, dv, gap, gap_srv))))
    else:
        raise ValueError(f"unknown eval_mode {eval_mode!r}")
    return [
        RunRecord(iteration=s.iteration, sim_time=s.sim_time,
                  gap=float(gap), gap_server=float(gap_srv), primal=float(p),
                  dual=float(dv), bytes_up=int(s.bytes_up),
                  bytes_down=int(s.bytes_down), compute_time=s.compute_time,
                  comm_time=s.comm_time)
        for s, (p, dv, gap, gap_srv) in zip(snaps, rows)
    ]


# ---------------------------------------------------------------------------
# Round bodies shared with the whole-run executor.
# ---------------------------------------------------------------------------


def lockstep_round(w: torch.Tensor, alpha: torch.Tensor, gamma, solve):
    """One lockstep round: all K local solves, then the aggregation.

    ``solve(w_all (K, d), alpha) -> (dalpha, v)`` runs the round's local
    solver on its orders; ``gamma`` is a float or a 0-dim float32 tensor
    (the same products either way). Returns the new ``(w, alpha)``.
    """
    K, d = alpha.shape[0], w.shape[0]
    dalpha, v = solve(w.expand(K, d).contiguous(), alpha)
    return w + gamma * torch.sum(v, dim=0), alpha + gamma * dalpha


def sigma_tensor(sigma_p: float, device) -> torch.Tensor:
    """sigma' as the 0-dim float32 tensor every local solve reads."""
    return torch.tensor(sigma_p, dtype=torch.float32, device=device)


def group_local_rounds(w_local, alpha, residual, widx, workers, idx,
                       problem: objectives.Problem, norms_sq, n: int, sigma_p,
                       gamma, comp, *, num_steps: int | None = None, map_error=None):
    """Alg. 2 lines 4-9 for the workers ``widx`` (an int64 index) against
    their fixed ``w_local`` rows, as one ``ops.sdca_epoch`` launch with the
    worker map ``workers`` (host data, or int32 on the device with its
    ``map_error`` word) on the visit orders ``idx (B, H)``. ``residual``
    holds their rows ``(B, d)``; ``alpha`` is updated in place. ``sigma_p``
    is a 0-dim float32 tensor that the kernel reads per row. Returns
    ``(alpha_rows, dw, sent, new_residual)``."""
    w_eff = w_local.index_select(0, widx) + gamma * residual
    dalpha, v = ops.sdca_epoch(w_eff, alpha, problem.X, problem.y, norms_sq, problem.lam,
                               n, 0.0, idx, loss=problem.loss, workers=workers,
                               map_error=map_error,
                               sigma_rows=sigma_p.expand(idx.shape[0]).contiguous())
    return group_local_finish(alpha, widx, residual, dalpha, v, gamma, comp)


def group_local_finish(alpha, widx, residual, dalpha, v, gamma, comp):
    """The rest of :func:`group_local_rounds` once the kernel has returned
    ``(dalpha, v)`` for the workers ``widx`` (a sweep batches several runs'
    launches into one and finishes each run here)."""
    alpha_rows = alpha.index_select(0, widx) + gamma * dalpha  # Alg. 2 line 5
    alpha.index_copy_(0, widx, alpha_rows)
    dw = residual + v  # line 6
    sent, new_residual = comp.compress(dw)
    return alpha_rows, dw, sent, new_residual


def lag_skip(ref_buf, ref_len, widx, xi, dw, sent, new_residual):
    """LAG's lazy upload for the workers ``widx``: a message whose
    ``||F(dw)||^2`` falls below ``xi`` times the mean of the worker's live
    window entries is skipped (zero payload, the whole ``dw`` kept as
    residual). Returns ``(sent, residual_rows, skip)``."""
    W = ref_buf.shape[1]
    lens = ref_len.index_select(0, widx)
    live = torch.arange(W, device=ref_buf.device)[None, :] < lens[:, None]
    total = torch.sum(torch.where(live, ref_buf.index_select(0, widx), 0.0), dim=1)
    ref = xi * total / torch.clamp(lens, min=1)
    skip = torch.sum(sent * sent, dim=1) < ref
    sent = torch.where(skip[:, None], torch.zeros_like(sent), sent)
    return sent, torch.where(skip[:, None], dw, new_residual), skip


def aggregate(w_server, dw_tilde, payloads, gamma):
    """Alg. 1 lines 8/10: gamma * (the payloads summed in arrival order)
    into the global model and every catch-up buffer; returns both."""
    total = torch.zeros_like(w_server)
    for payload in payloads:
        total = total + payload
    return w_server + gamma * total, dw_tilde + gamma * total[None, :]


def aggregate_masked(w_server, dw_tilde, payloads, take, gamma):
    """:func:`aggregate` over the payloads whose ``take`` (a 0-dim bool
    tensor each) is set, without a host sync: a skipped payload keeps the
    running sum (``where``), so the sum is the one of the taken payloads in
    order, bit for bit."""
    total = torch.zeros_like(w_server)
    for payload, t in zip(payloads, take):
        total = torch.where(t, total + payload, total)
    return w_server + gamma * total, dw_tilde + gamma * total[None, :]


def apply_snapshots(alpha_applied, widx, snapshots, applied):
    """The arrived messages' dual snapshots become server-visible, except
    where ``applied`` is False (LAG heartbeats); returns a new tensor."""
    rows = alpha_applied.index_select(0, widx)
    return alpha_applied.index_copy(0, widx, torch.where(applied[:, None], snapshots, rows))


def reply(w_local, dw_tilde, widx):
    """Catch-up replies to the workers ``widx``, in place: ``w_local +=
    dw_tilde`` and ``dw_tilde = 0`` on their rows. Returns the replies'
    squared norms (LAG's window) and nonzero counts (their bytes)."""
    replies = dw_tilde.index_select(0, widx)
    reply_sq = torch.sum(replies * replies, dim=1)
    nnz = torch.sum(replies != 0, dim=1)
    w_local.index_copy_(0, widx, w_local.index_select(0, widx) + replies)
    dw_tilde.index_fill_(0, widx, 0.0)
    return reply_sq, nnz


def lag_window_append(ref_buf, ref_len, widx, reply_sq) -> None:
    """Slide the replies' energies into the workers' windows, in place
    (append while filling, shift left and append once full)."""
    W = ref_buf.shape[1]
    rows = ref_buf.index_select(0, widx)
    lens = ref_len.index_select(0, widx)
    full = (lens >= W)[:, None]
    rows = torch.where(full, torch.roll(rows, -1, dims=1), rows)
    pos = torch.clamp(lens, max=W - 1).long()
    rows.scatter_(1, pos[:, None], reply_sq[:, None])
    ref_buf.index_copy_(0, widx, rows)
    ref_len.index_copy_(0, widx, torch.clamp(lens + 1, max=W))


# ---------------------------------------------------------------------------
# Protocols.
# ---------------------------------------------------------------------------


class Protocol:
    """Arrival + aggregation + reply rules driving the Session's event loop.

    **Classmethod contract** (consulted before an instance exists):

    ``default_sigma_prime(method, K)``
        sigma' when ``MethodConfig.sigma_prime`` is None: gamma * B for B-of-K
        group aggregation, gamma * K for "adding" CoCoA+ aggregation, 1 for
        "averaging" CoCoA aggregation. Every registered entry states it in
        its own class chain.

    **Instance hooks, in the order the Session loop calls them:**
    ``num_rounds(num_outer)`` (total server rounds), ``initial_messages()``
    (launch every worker's first round; the Messages seed the queue),
    ``arrivals_needed(round_index)`` (the arrival rule, re-read every round),
    ``is_sync_round(round_index)`` (a full-K barrier: the Session emits a
    SyncEvent), ``process_round(round_index, arrived)`` (aggregation + reply:
    fold payloads in, bill replies, advance ``sim_time``, return the next
    wave of Messages), ``snapshot(iteration)`` (device state for a deferred
    certificate) and ``finalize(records)`` (fold into a RunResult).

    Timing comes from ``self.delay``, a fresh ``DelayModel`` per run; host
    randomness from ``self.rng`` (numpy, seeded by ``seed`` as in the JAX
    package) and device randomness from ``self.draws`` starting at
    ``self.key``.
    """

    protocol_name = "abstract"
    # True for protocols that honor ClusterModel.membership (elastic worker
    # dropout/rejoin schedules); the others refuse a non-empty schedule.
    supports_membership = False

    @classmethod
    def default_sigma_prime(cls, method: MethodConfig, K: int) -> float:
        """sigma' when ``MethodConfig.sigma_prime`` is unset: gamma * B."""
        return method.gamma * method.B

    @classmethod
    def coalesce_supported(cls, method: MethodConfig,
                           cluster: ClusterModel) -> tuple[bool, str]:
        """May runs of this protocol join a coalesced sweep batch (the serve
        layer's batching rule)? Returns ``(ok, reason)``.

        The base rule is the whole-run executor's eligibility: a run the
        executor can express is one sweep cell. Protocols whose executor path
        is not the shared lockstep/lag cell (``partial_work``) refuse.
        """
        from repro_torch.core import executor  # late import: executor imports us

        return executor.scan_supported(method, cluster)

    def __init__(self, problem: objectives.Problem, method: MethodConfig,
                 cluster: ClusterModel, *, seed: int, draws=None):
        if cluster.membership and not self.supports_membership:
            raise ValueError(
                f"protocol {self.protocol_name!r} does not support elastic "
                f"membership; ClusterModel.membership is non-empty. Use a "
                f"protocol declaring supports_membership (e.g. "
                f"'partial_work') or clear the membership schedule.")
        self.problem = problem
        self.method = method
        self.cluster = cluster
        self.delay = cluster.make_delay()  # fresh per run; may be stateful
        self.K, self.n_k, self.d = problem.X.shape
        self.n = self.K * self.n_k
        self.device = problem.X.device
        self.sigma_p = sigma_tensor(method.resolved_sigma_prime(self.K), self.device)
        self.rng = np.random.default_rng(seed)
        self.draws = TorchDraws(seed, self.device) if draws is None else draws
        self.key = self.draws.root()
        self.bytes_up = 0
        self.bytes_down = 0
        self.compute_time = 0.0
        self.comm_time = 0.0
        self.sim_time = 0.0
        self.seq = 0

    def _split(self):
        """The next sub-key of the run's chain (``key, sub = split(key)``)."""
        self.key, sub = self.draws.split(self.key, 2)
        return sub

    def _index(self, workers) -> torch.Tensor:
        return torch.tensor(workers, dtype=torch.int64, device=self.device)

    # --- hooks the Session loop calls (contract in the class docstring) ---

    def num_rounds(self, num_outer: int) -> int:
        raise NotImplementedError

    def initial_messages(self) -> Iterable[Message]:
        raise NotImplementedError

    def arrivals_needed(self, round_index: int) -> int:
        raise NotImplementedError

    def is_sync_round(self, round_index: int) -> bool:
        """True when round ``round_index`` is a full-K barrier (SyncEvent)."""
        return False

    def process_round(self, round_index: int, arrived: list[Message]) -> list[Message]:
        raise NotImplementedError

    def snapshot(self, iteration: int) -> _Snapshot:
        raise NotImplementedError

    def finalize(self, records: list[RunRecord]) -> RunResult:
        raise NotImplementedError


@register_protocol("group")
class GroupProtocol(Protocol):
    """Algorithms 1+2: straggler-agnostic B-of-K server with catch-up buffers."""

    full_sync_period: bool = True  # every T-th round is a K-barrier

    @classmethod
    def default_sigma_prime(cls, method: MethodConfig, K: int) -> float:
        # The paper's rule: sigma' covers the B updates a round aggregates.
        return method.gamma * method.B

    @classmethod
    def coalesce_supported(cls, method: MethodConfig,
                           cluster: ClusterModel) -> tuple[bool, str]:
        # Group runs coalesce exactly when the executor can express them as
        # shared sweep cells (the base rule, stated per family).
        return super().coalesce_supported(method, cluster)

    def __init__(self, problem, method, cluster, *, seed, draws=None):
        super().__init__(problem, method, cluster, seed=seed, draws=draws)
        dt, dev = problem.X.dtype, self.device
        self.comp = compress_lib.for_method(method, self.d)
        self.dense = isinstance(self.comp, compress_lib.Dense)
        self.up_bytes = self.comp.wire_bytes(self.d)
        self.w_server = torch.zeros((self.d,), dtype=dt, device=dev)
        self.dw_tilde = torch.zeros((self.K, self.d), dtype=dt, device=dev)
        self.w_local = torch.zeros((self.K, self.d), dtype=dt, device=dev)
        self.alpha_applied = torch.zeros((self.K, self.n_k), dtype=dt, device=dev)
        self.alpha = torch.zeros((self.K, self.n_k), dtype=dt, device=dev)
        self.residual = torch.zeros((self.K, self.d), dtype=dt, device=dev)
        self.norms_sq = torch.sum(problem.X * problem.X, dim=-1)

    def num_rounds(self, num_outer: int) -> int:
        return num_outer * self.method.T

    def initial_messages(self):
        return self._launch_workers([(k, 0.0) for k in range(self.K)])

    def arrivals_needed(self, round_index: int) -> int:
        T = self.method.T
        if self.full_sync_period and round_index % T == T - 1:
            return self.K
        return min(self.method.B, self.K)

    def is_sync_round(self, round_index: int) -> bool:
        T = self.method.T
        return self.full_sync_period and round_index % T == T - 1

    # -- the group relaunch: one kernel launch --------------------------------

    def _local_rounds(self, workers: list[int], widx: torch.Tensor, keys, num_steps: int,
                      sigma_p: torch.Tensor, residual: torch.Tensor):
        """Alg. 2 lines 4-9 for distinct ``workers`` against their fixed
        ``w_local`` rows, as one ``ops.sdca_epoch`` launch with the worker
        map. ``residual`` holds their rows ``(B, d)``; ``self.alpha`` is
        updated in place. Returns (alpha_rows, dw, sent, new_residual)."""
        idx = as_orders(self.draws.randint(keys, self.n_k, num_steps), self.device)
        return group_local_rounds(self.w_local, self.alpha, residual, widx, workers, idx,
                                  self.problem, self.norms_sq, self.n, sigma_p,
                                  self.method.gamma, self.comp)

    def _round_payloads(self, workers: list[int]):
        """Run the group's local rounds; returns (alpha_rows, sents, skip
        flags or None). Subclasses (LAG) override to add laziness."""
        widx = self._index(workers)
        keys = [self._split() for _ in workers]
        alpha_rows, _, sents, new_res = self._local_rounds(
            workers, widx, keys, self.method.H, self.sigma_p,
            self.residual.index_select(0, widx))
        self.residual.index_copy_(0, widx, new_res)
        return alpha_rows, sents, None

    def _message_bytes(self, skipped: bool) -> int:
        return self.up_bytes

    def _launch_workers(self, starts, pre_account=None):
        """Launch local rounds for ``starts = [(worker, start_time), ...]``
        (arrival order) as ONE launch, then do the host-side accounting per
        worker.

        ``pre_account``: optional per-worker ``(rbytes, down_time)`` reply
        billing, applied immediately before each worker's own launch
        accounting -- the float accumulation order of the reference loops
        (down_0, up_0, down_1, up_1, ...).
        """
        if not starts:
            return []
        m = self.method
        # One size-K numpy draw per round for vector-sampled delay models,
        # per-message scalar draws otherwise (the JAX package's order).
        durations = (self.delay.sample_round(m.H, self.rng)
                     if self.delay.vector_sampled else None)
        alpha_rows, sents, skips = self._round_payloads([k for k, _ in starts])
        out = []
        for j, (k, start) in enumerate(starts):
            if pre_account is not None:
                rbytes, down_time = pre_account[j]
                self.bytes_down += rbytes
                self.comm_time += down_time
            skipped = bool(skips[j]) if skips is not None else False
            nbytes = self._message_bytes(skipped)
            duration = (durations[k] if durations is not None
                        else self.delay.compute_time(k, m.H, self.rng))
            up_time = self.delay.p2p_time(nbytes, k)
            self.compute_time += duration
            self.comm_time += up_time
            self.bytes_up += nbytes
            self.seq += 1
            msg = Message(start + duration + up_time, k, sents[j],
                          alpha_rows[j], nbytes, self.seq,
                          applied=not skipped)
            self._observe_launch(k, start, msg.arrival)
            out.append(msg)
        return out

    def _observe_launch(self, k: int, start: float, arrival: float) -> None:
        """Per-launch hook (adaptive disciplines observe round latencies)."""

    def _reply(self, reply_workers: list[int]):
        """Catch-up replies to ``reply_workers``: ``w_local += dw_tilde`` and
        ``dw_tilde = 0`` on their rows; returns the replies' nnz on the host
        (None when replies are dense: their byte count is static)."""
        widx = self._index(reply_workers)
        # LAG reads the squared norms.
        self._last_reply_sq, nnz = reply(self.w_local, self.dw_tilde, widx)
        if self.dense or not reply_workers:
            return None
        return nnz.tolist()  # the one sync of the round

    def _aggregate(self, payloads) -> None:
        """Alg. 1 lines 8/10 (:func:`aggregate`)."""
        self.w_server, self.dw_tilde = aggregate(self.w_server, self.dw_tilde, payloads,
                                                 self.method.gamma)

    def _apply_server(self, arrived):
        """Aggregation + replies; returns (server_time, reply nnz)."""
        server_time = max(m.arrival for m in arrived)
        workers = [m.worker for m in arrived]
        self._aggregate(m.payload for m in arrived)
        # LAG heartbeats' dual snapshots must not become server-visible.
        mask = torch.tensor([m.applied for m in arrived], device=self.device)
        snap = torch.stack([m.alpha_snapshot for m in arrived])
        self.alpha_applied = apply_snapshots(self.alpha_applied, self._index(workers), snap,
                                             mask)
        return server_time, self._reply(workers)

    def _reply_billing(self, j, worker, nnz_host) -> tuple[int, float]:
        """(bytes, link time) of arrival ``j``'s catch-up reply."""
        rbytes = (msg_filter.dense_bytes(self.d) if self.dense
                  else msg_filter.message_bytes(int(nnz_host[j])))
        return rbytes, self.delay.p2p_time(rbytes, worker)

    def _relaunch(self, server_time, workers, nnz_host):
        """Bill each reply up front, account it inside the launch loop."""
        starts, billing = [], []
        for j, k in enumerate(workers):
            rbytes, down_time = self._reply_billing(j, k, nnz_host)
            starts.append((k, server_time + down_time))
            billing.append((rbytes, down_time))
        self.sim_time = server_time
        return self._launch_workers(starts, pre_account=billing)

    def process_round(self, round_index, arrived):
        server_time, nnz_host = self._apply_server(arrived)
        return self._relaunch(server_time, [m.worker for m in arrived], nnz_host)

    def snapshot(self, iteration):
        return _Snapshot(iteration, self.sim_time, self.bytes_up,
                         self.bytes_down, self.compute_time, self.comm_time,
                         self.w_server, self.alpha_applied)

    def finalize(self, records):
        return RunResult(self.method, records, self.w_server.cpu().numpy(),
                         self.alpha.cpu().numpy(),
                         alpha_applied=self.alpha_applied.cpu().numpy())


@register_protocol("async")
class AsyncProtocol(GroupProtocol):
    """Fully-asynchronous ablation: B=1, per-worker apply, no sync barrier."""

    full_sync_period = False

    @classmethod
    def default_sigma_prime(cls, method: MethodConfig, K: int) -> float:
        return method.gamma * method.B  # B = 1: one update a round

    def __init__(self, problem, method, cluster, *, seed, draws=None):
        if method.B != 1:
            raise ValueError(
                f"protocol 'async' is defined by B=1 (per-arrival apply); "
                f"got B={method.B}. Use protocol='group' for B-of-K "
                f"aggregation, or baselines.acpd_async() for a valid config.")
        super().__init__(problem, method, cluster, seed=seed, draws=draws)


@register_protocol("lag")
class LagProtocol(GroupProtocol):
    """Group protocol + LAG-style lazy uploads (arXiv:1805.09965 adapted).

    A worker skips its upload when ``||F(dw)||^2 < xi * ref``, ``ref`` the
    mean of the squared norms of its last ``lag_window`` catch-up replies;
    the skipped mass stays in its residual, and it sends an 8-byte heartbeat
    that the server treats as an arrival but does not apply. The window is a
    fixed-width ``(K, lag_window)`` buffer with per-worker fill counts,
    summed afresh each round over its live entries.
    """

    HEARTBEAT_BYTES = 8

    @classmethod
    def default_sigma_prime(cls, method: MethodConfig, K: int) -> float:
        return method.gamma * method.B

    def __init__(self, problem, method, cluster, *, seed, draws=None):
        if method.lag_window < 1:
            raise ValueError(
                f"lag_window must be >= 1, got {method.lag_window}")
        super().__init__(problem, method, cluster, seed=seed, draws=draws)
        # Empty windows => ref 0 => the first rounds always upload.
        self._ref_buf = torch.zeros((self.K, method.lag_window), dtype=problem.X.dtype,
                                    device=self.device)
        self._ref_len = torch.zeros((self.K,), dtype=torch.int32, device=self.device)

    def _round_payloads(self, workers):
        widx = self._index(workers)
        keys = [self._split() for _ in workers]
        alpha_rows, dw, sents, new_res = self._local_rounds(
            workers, widx, keys, self.method.H, self.sigma_p,
            self.residual.index_select(0, widx))
        sents, res_rows, skip = lag_skip(self._ref_buf, self._ref_len, widx,
                                         self.method.lag_xi, dw, sents, new_res)
        self.residual.index_copy_(0, widx, res_rows)
        return alpha_rows, sents, skip.tolist()  # one pull per group

    def _message_bytes(self, skipped):
        return self.HEARTBEAT_BYTES if skipped else self.up_bytes

    def _window_append(self, workers) -> None:
        """Slide this round's reply energies into the arrived workers' windows
        (append while filling, shift left and append once full)."""
        lag_window_append(self._ref_buf, self._ref_len, self._index(workers),
                          self._last_reply_sq)

    def process_round(self, round_index, arrived):
        server_time, nnz_host = self._apply_server(arrived)
        workers = [m.worker for m in arrived]
        self._window_append(workers)
        return self._relaunch(server_time, workers, nnz_host)


@register_protocol("sync")
class SyncProtocol(Protocol):
    """CoCoA / CoCoA+ / DisDCA: lockstep rounds timed as an MPI allreduce.

    The queue degenerates to K tokens popped per round; a round is one
    launch for all K workers, and its timing is max worker compute + ring
    allreduce, bytes split evenly between reduce-scatter and all-gather.
    """

    @classmethod
    def default_sigma_prime(cls, method: MethodConfig, K: int) -> float:
        # "Adding" aggregation over all K partitions (Ma et al. 2015).
        return method.gamma * K

    @classmethod
    def coalesce_supported(cls, method: MethodConfig,
                           cluster: ClusterModel) -> tuple[bool, str]:
        # Lockstep rounds are the sweep's native shape; the executor's rule
        # decides the rest.
        return super().coalesce_supported(method, cluster)

    def __init__(self, problem, method, cluster, *, seed, draws=None):
        super().__init__(problem, method, cluster, seed=seed, draws=draws)
        dt, dev = problem.X.dtype, self.device
        self.w = torch.zeros((self.d,), dtype=dt, device=dev)
        self.alpha = torch.zeros((self.K, self.n_k), dtype=dt, device=dev)
        self.norms_sq = torch.sum(problem.X * problem.X, dim=-1)
        self.solver = solvers_lib.get_solver("sdca")

    def num_rounds(self, num_outer: int) -> int:
        return num_outer

    def is_sync_round(self, round_index: int) -> bool:
        return True  # every lockstep round is a K-barrier

    def _tokens(self):
        out = []
        for k in range(self.K):
            self.seq += 1
            out.append(Message(self.sim_time, k, None, None, 0, self.seq))
        return out

    def initial_messages(self):
        return self._tokens()

    def arrivals_needed(self, round_index: int) -> int:
        return self.K

    def _round_update(self):
        """One lockstep round: all K subproblems, then the aggregation."""
        m, p = self.method, self.problem
        keys = self.draws.split(self._split(), self.K)

        def solve(w_all, alpha):
            return self.solver(w_all, alpha, p.X, p.y, self.norms_sq, p.lam, self.n,
                               self.sigma_p, keys, self.draws, loss=p.loss, num_steps=m.H)

        self.w, self.alpha = lockstep_round(self.w, self.alpha, m.gamma, solve)

    def process_round(self, round_index, arrived):
        m = self.method
        self._round_update()
        # One per-round vector draw (the same host-RNG stream as K scalar
        # calls in worker order).
        step_compute = float(np.max(self.delay.sample_round(m.H, self.rng)))
        step_comm = self.delay.allreduce_time(self.d)
        self.sim_time += step_compute + step_comm
        self.compute_time += step_compute
        self.comm_time += step_comm
        phase = (self.K - 1) * self.d * 4  # ring reduce-scatter == all-gather
        self.bytes_up += phase
        self.bytes_down += phase
        return self._tokens()

    def snapshot(self, iteration):
        return _Snapshot(iteration, self.sim_time, self.bytes_up,
                         self.bytes_down, self.compute_time, self.comm_time,
                         self.w, self.alpha)

    def finalize(self, records):
        return RunResult(self.method, records, self.w.cpu().numpy(),
                         self.alpha.cpu().numpy())


@register_protocol("cocoa")
class CocoaProtocol(SyncProtocol):
    """CoCoA v1 (Jaggi et al., arXiv:1409.1458): synchronous rounds,
    "averaging" aggregation, the local solver from the
    :mod:`repro_torch.core.solvers` registry (``MethodConfig.local_solver``).
    Averaging is safe with sigma' = 1 for ``gamma <= 1/K``.
    """

    @classmethod
    def default_sigma_prime(cls, method: MethodConfig, K: int) -> float:
        # "Averaging" aggregation (Jaggi et al. 2014): safe for gamma <= 1/K.
        return 1.0

    def __init__(self, problem, method, cluster, *, seed, draws=None):
        K = problem.X.shape[0]
        if (self.protocol_name == "cocoa" and method.sigma_prime is None
                and method.gamma > 1.0 / K + 1e-9):
            raise ValueError(
                f"protocol 'cocoa' uses averaging aggregation (sigma'=1), "
                f"which is only safe for gamma <= 1/K; got gamma="
                f"{method.gamma} with K={K}. Use baselines.cocoa_v1, "
                f"protocol='cocoa_plus' for adding aggregation, or set "
                f"sigma_prime explicitly.")
        super().__init__(problem, method, cluster, seed=seed, draws=draws)
        self.solver = solvers_lib.get_solver(method.local_solver)


@register_protocol("cocoa_plus")
class CocoaPlusProtocol(CocoaProtocol):
    """CoCoA+ (Ma et al. 2015): "adding" aggregation, pluggable local solver,
    safe subproblem scaling ``sigma' = gamma * K``."""

    @classmethod
    def default_sigma_prime(cls, method: MethodConfig, K: int) -> float:
        return method.gamma * K


@register_protocol("adaptive_b")
class AdaptiveBProtocol(GroupProtocol):
    """Group protocol with the group size B adapted to observed arrivals.

    Keeps an EWMA of each worker's round latency (launch -> arrival) and
    waits each round for the workers in the fast ``adaptive_quantile`` of
    that distribution::

        B_t = clip(#{k : ewma_k <= quantile_q(ewma)}, b_min, ceil(q * K))

    The upper clip is the aggregation size ``default_sigma_prime`` covers.
    The T-periodic full barrier is kept; ``MethodConfig.B`` only seeds the
    rounds before one latency sample per worker exists.
    """

    @classmethod
    def default_sigma_prime(cls, method: MethodConfig, K: int) -> float:
        target_b = max(method.b_min, math.ceil(method.adaptive_quantile * K))
        return method.gamma * target_b

    def __init__(self, problem, method, cluster, *, seed, draws=None):
        if not 0.0 < method.adaptive_quantile <= 1.0:
            raise ValueError(
                f"adaptive_quantile must be in (0, 1], got "
                f"{method.adaptive_quantile}")
        if not 0.0 < method.adaptive_ewma <= 1.0:
            raise ValueError(
                f"adaptive_ewma must be in (0, 1], got {method.adaptive_ewma}")
        super().__init__(problem, method, cluster, seed=seed, draws=draws)
        self._latency = np.full(self.K, np.nan)  # EWMA round latency
        self._b_lo = max(1, method.b_min)
        self._b_hi = min(self.K, max(self._b_lo,
                                     math.ceil(method.adaptive_quantile
                                               * self.K)))
        self._B = int(np.clip(method.B, self._b_lo, self._b_hi))

    @property
    def current_b(self) -> int:
        """The group size the next non-barrier round will wait for."""
        return self._B

    def arrivals_needed(self, round_index: int) -> int:
        T = self.method.T
        if round_index % T == T - 1:
            return self.K  # the staleness-bounding full barrier stays
        return self._B

    def _observe_launch(self, k, start, arrival):
        latency = arrival - start
        beta = self.method.adaptive_ewma
        if np.isnan(self._latency[k]):
            self._latency[k] = latency
        else:
            self._latency[k] = (1.0 - beta) * self._latency[k] + beta * latency
        if not np.isnan(self._latency).any():
            cut = np.quantile(self._latency, self.method.adaptive_quantile)
            self._B = int(np.clip(int(np.sum(self._latency <= cut)),
                                  self._b_lo, self._b_hi))


def chunk_steps(H: int, n_chunks: int) -> tuple[int, ...]:
    """Split ``H`` local steps into ``n_chunks`` near-equal chunk sizes
    (earlier chunks take the remainder; sums to exactly ``H``)."""
    base, rem = divmod(H, n_chunks)
    return tuple(base + (1 if i < rem else 0) for i in range(n_chunks))


@register_protocol("partial_work")
class PartialWorkProtocol(GroupProtocol):
    """Straggler-utilizing group rounds: harvest chunk-level partial work.

    Each local pass of ``H`` steps is split into ``MethodConfig.n_chunks``
    chunks; the worker compresses and uploads every chunk as it finishes,
    and the server's round deadline is the B-th FULL arrival (a worker's last
    chunk), or every ``pw_quantum`` simulated seconds when set. The server
    folds every chunk that arrived by the deadline into the catch-up buffers;
    only completed workers are replied to and relaunched. With
    ``n_chunks=1`` it is ``group``, launch for launch.

    Elasticity: this protocol honors ``ClusterModel.membership``. A dropping
    worker's unsent chunks are rolled back to its last sent chunk, its bytes
    stop accruing, and the deadline shrinks with the live membership
    (``b_eff = min(B, pending full passes)``). A rejoining worker receives a
    dense catch-up reply and re-enters the launch stream at its rejoin.
    """

    supports_membership = True

    @classmethod
    def default_sigma_prime(cls, method: MethodConfig, K: int) -> float:
        # gamma * B by mass conservation: a round folds B pass-equivalents
        # of update mass in steady state; min(B, K) for the elastic rescaling.
        return method.gamma * min(method.B, K)

    @classmethod
    def coalesce_supported(cls, method: MethodConfig,
                           cluster: ClusterModel) -> tuple[bool, str]:
        return (False, "protocol 'partial_work' streams per-chunk arrivals "
                       "(per-chunk state in the executor); its runs are not "
                       "expressible as shared lockstep/lag sweep cells")

    def __init__(self, problem, method, cluster, *, seed, draws=None):
        if method.n_chunks < 1:
            raise ValueError(f"n_chunks must be >= 1, got {method.n_chunks}")
        if method.n_chunks > method.H:
            raise ValueError(
                f"n_chunks={method.n_chunks} exceeds H={method.H}: every "
                f"chunk needs at least one local step")
        if method.pw_quantum is not None and method.pw_quantum <= 0:
            raise ValueError(
                f"pw_quantum must be > 0 (simulated seconds per harvest "
                f"tick), got {method.pw_quantum}")
        super().__init__(problem, method, cluster, seed=seed, draws=draws)
        self._chunk_steps = chunk_steps(method.H, method.n_chunks)
        # Host mirror of the in-flight queue: seq -> (arrival, worker, final).
        self._pending: dict[int, tuple[float, int, bool]] = {}
        # Rejoin schedule, time-ascending; popped as the clock passes each.
        self._rejoins = sorted(
            (r, k) for k, _, r in cluster.membership if r is not None)

    # -- arrival rule ------------------------------------------------------

    def initial_messages(self):
        return self._launch_workers(
            [(k, 0.0) for k in range(self.K)
             if self.cluster.live_at(k, 0.0)])

    def arrivals_needed(self, round_index: int) -> int:
        T = self.method.T
        if self.full_sync_period and round_index % T == T - 1:
            return len(self._pending)  # barrier: drain every in-flight chunk
        if not self._pending:
            return 0  # starved (all live workers dropped): see process_round
        if self.method.pw_quantum is not None:
            deadline = self.sim_time + self.method.pw_quantum
            return sum(1 for a, _, _ in self._pending.values()
                       if a <= deadline)
        fulls = sorted((a, s) for s, (a, _, f) in self._pending.items() if f)
        if not fulls:
            return len(self._pending)  # only orphan chunks left: drain them
        b_eff = min(self.method.B, len(fulls))  # the deadline shrinks with
        cut = fulls[b_eff - 1]                  # the live membership
        return sum(1 for s, (a, _, _) in self._pending.items()
                   if (a, s) <= cut)

    # -- aggregation + reply rules -----------------------------------------

    def process_round(self, round_index, arrived):
        m = self.method
        T = m.T
        barrier = self.full_sync_period and round_index % T == T - 1
        quantum = m.pw_quantum is not None and not barrier
        for msg in arrived:
            del self._pending[msg.seq]
        if quantum:
            server_time = self.sim_time + m.pw_quantum  # fixed harvest tick
        elif arrived:
            server_time = max(msg.arrival for msg in arrived)
        elif self._rejoins:
            # Starved: every live worker dropped mid-pass. Jump the clock to
            # the next rejoin so elasticity can never hang the round loop.
            server_time = max(self.sim_time, self._rejoins[0][0])
        else:
            return []  # permanently starved; remaining rounds are no-ops
        completed = [msg.worker for msg in arrived if msg.final
                     and self.cluster.live_at(msg.worker, server_time)]
        rejoiners = [k for k in self._collect_rejoiners(server_time)
                     if self.cluster.live_at(k, server_time)
                     and k not in completed]
        reply_to = completed + rejoiners
        nnz_host = None
        if arrived or reply_to:
            self._aggregate(msg.payload for msg in arrived)
            last = {}  # worker -> LAST harvested chunk's dual snapshot
            for msg in arrived:
                last[msg.worker] = msg.alpha_snapshot
            if last:
                alpha_applied = self.alpha_applied.clone()
                alpha_applied[self._index(list(last))] = torch.stack(list(last.values()))
                self.alpha_applied = alpha_applied
            nnz_host = self._reply(reply_to)
        return self._relaunch(server_time, reply_to, nnz_host)

    def _collect_rejoiners(self, upto: float) -> list[int]:
        out = []
        while self._rejoins and self._rejoins[0][0] <= upto:
            out.append(self._rejoins.pop(0)[1])
        return out

    def _live_sigma(self) -> torch.Tensor:
        """sigma' for the next launch wave: the default formula at the LIVE
        worker count when elastic, the run's resolved sigma' otherwise."""
        if self.method.sigma_prime is not None or not self.cluster.membership:
            return self.sigma_p
        live = max(1, sum(self.cluster.live_at(k, self.sim_time)
                          for k in range(self.K)))
        return sigma_tensor(self.default_sigma_prime(self.method, live), self.device)

    # -- the chunked launch: one kernel launch per chunk --------------------

    def _launch_workers(self, starts, pre_account=None):
        """Launch chunked local passes for ``starts = [(worker, start), ...]``,
        one ``ops.sdca_epoch`` launch per chunk for all of them, then account
        each SENT chunk host-side (replacing the group's one-chunk launch).

        A chunk is sent only if its compute finishes strictly before the
        worker's next scheduled drop; a truncated pass rolls the worker's
        dual/residual back to its last sent chunk.
        """
        if not starts:
            return []
        m = self.method
        C = len(self._chunk_steps)
        if self.delay.vector_sampled:
            sampled = self.delay.sample_chunks(self._chunk_steps, self.rng)
            durations = [[sampled[c][k] for c in range(C)]
                         for k, _ in starts]
        else:
            durations = [[self.delay.compute_time(k, h, self.rng)
                          for h in self._chunk_steps] for k, _ in starts]
        finishes, n_sent = [], []
        for j, (k, start) in enumerate(starts):
            drop = self.cluster.next_drop_after(k, start)
            fin, t = [], start
            for c in range(C):
                t = t + durations[j][c]
                fin.append(t)
            finishes.append(fin)
            n_sent.append(sum(1 for t in fin if t < drop))
        workers = [k for k, _ in starts]
        widx = self._index(workers)
        saved = {j: (self.alpha[k].clone(), self.residual[k].clone())
                 for j, k in enumerate(workers) if n_sent[j] == 0}
        # The JAX package's draw order: worker-major, one split per chunk.
        keys = [[self._split() for _ in range(C)] for _ in workers]
        sigma_p = self._live_sigma()
        residual = self.residual.index_select(0, widx)
        alpha_rows, sents, resids = [], [], []
        for c, h in enumerate(self._chunk_steps):
            a_c, _, sent, residual = self._local_rounds(
                workers, widx, [ks[c] for ks in keys], h, sigma_p, residual)
            alpha_rows.append(a_c)
            sents.append(sent)
            resids.append(residual)
        self.residual.index_copy_(0, widx, residual)
        out = []
        for j, (k, start) in enumerate(starts):
            if pre_account is not None:
                rbytes, down_time = pre_account[j]
                self.bytes_down += rbytes
                self.comm_time += down_time
            for c in range(n_sent[j]):
                nbytes = self.up_bytes  # the one compressor formula, per chunk
                up_time = self.delay.p2p_time(nbytes, k)
                self.compute_time += durations[j][c]
                self.comm_time += up_time
                self.bytes_up += nbytes
                self.seq += 1
                msg = Message(finishes[j][c] + up_time, k, sents[c][j],
                              alpha_rows[c][j], nbytes, self.seq,
                              chunk=c, final=(c == C - 1))
                self._pending[self.seq] = (msg.arrival, k, msg.final)
                out.append(msg)
            if n_sent[j] < C:
                if n_sent[j] == 0:
                    row_a, row_r = saved[j]
                else:
                    row_a = alpha_rows[n_sent[j] - 1][j]
                    row_r = resids[n_sent[j] - 1][j]
                self.alpha[k] = row_a
                self.residual[k] = row_r
        return out


@register_protocol("hierarchical_b")
class HierarchicalBProtocol(GroupProtocol):
    """Two-level rack-aware aggregation: per-rack B-of-k, then cross-rack.

    Workers are split into ``MethodConfig.n_racks`` contiguous racks (worker
    ``k`` in rack ``k * n_racks // K``). A round's deadline is the first
    instant at which EVERY rack has at least ``rack_b`` arrivals; the merge
    is the inherited arrival-order catch-up aggregation. The T-periodic full
    barrier is kept; sigma' covers ``n_racks * rack_b`` aggregated passes.
    """

    @classmethod
    def default_sigma_prime(cls, method: MethodConfig, K: int) -> float:
        return method.gamma * max(1, method.n_racks * method.rack_b)

    def __init__(self, problem, method, cluster, *, seed, draws=None):
        K = problem.X.shape[0]
        if not 1 <= method.n_racks <= K:
            raise ValueError(
                f"n_racks must be in [1, K={K}], got {method.n_racks}")
        self._rack_of = [k * method.n_racks // K for k in range(K)]
        rack_sizes = [self._rack_of.count(r) for r in range(method.n_racks)]
        if not 1 <= method.rack_b <= min(rack_sizes):
            raise ValueError(
                f"rack_b must be in [1, min rack size={min(rack_sizes)}] "
                f"(racks of {rack_sizes}), got {method.rack_b}")
        super().__init__(problem, method, cluster, seed=seed, draws=draws)
        # One in-flight message per worker (the group-family invariant),
        # recorded at launch so the arrival rule can count per-rack prefixes.
        self._pending: dict[int, tuple[float, int, int]] = {}

    def _observe_launch(self, k, start, arrival):
        self._pending[self.seq] = (arrival, self.seq, k)

    def arrivals_needed(self, round_index: int) -> int:
        T = self.method.T
        if self.full_sync_period and round_index % T == T - 1:
            return self.K
        need = [self.method.rack_b] * self.method.n_racks
        outstanding = sum(need)
        for count, (_, _, k) in enumerate(
                sorted(self._pending.values()), start=1):
            r = self._rack_of[k]
            if need[r] > 0:
                need[r] -= 1
                outstanding -= 1
                if outstanding == 0:
                    return count
        return len(self._pending)  # unreachable under the launch invariant

    def process_round(self, round_index, arrived):
        for msg in arrived:
            del self._pending[msg.seq]
        return super().process_round(round_index, arrived)


def run_method(problem: objectives.Problem, method: MethodConfig, cluster: ClusterModel,
               *, num_outer: int, seed: int = 0, eval_every: int = 1,
               eval_mode: str = "batched", draws=None, device=None) -> RunResult:
    """Run ``method`` through the engine: drains a
    :class:`repro_torch.api.session.Session` and returns its RunResult."""
    from repro_torch.api.session import Session  # late import: api imports engine

    return Session(problem, method, cluster, num_outer=num_outer, seed=seed,
                   eval_every=eval_every, eval_mode=eval_mode, executor="event",
                   draws=draws, device=device).run()
