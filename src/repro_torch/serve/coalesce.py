"""Request coalescing: which pending requests may share one compiled batch.

PyTorch counterpart of ``repro.serve.coalesce``: the same keys and policy.
The shard plan in the key is resolved against the one device a port sweep
runs on, so it is always the unsharded plan.

A tenant request is ONE method entry of one :class:`ExperimentSpec` -- one
sweep cell.  Two requests can run in the same :func:`repro_torch.api.run_sweep_cells`
call exactly when everything that is STATIC to the compiled computation (or a
shared traced operand) matches; everything that enters per cell may differ
freely:

===================  =====================================================
shared (batch key)   problem entry + params, protocol family statics
                     (H, T, B, rho, compressor, local solver, lag window,
                     lag xi, chunking: n_chunks / pw_quantum / n_racks /
                     rack_b), ``num_outer``, eval cadence, batch mode,
                     resolved shard plan
per cell (free)      ``cluster`` (the WHOLE delay axis: model, params,
                     latency, bandwidth, stragglers, membership), ``seed``,
                     ``gamma``, ``sigma_prime``
===================  =====================================================

WHETHER a request may coalesce at all is the protocol registry's own call:
the service's admission gate (``executor.coalesce_supported``) delegates to
:meth:`repro_torch.core.engine.Protocol.coalesce_supported`, so e.g.
``partial_work`` (per-chunk scan carries) and ``hierarchical_b``
(rack-dependent pop counts) decline batching and ride the solo lane -- one
:class:`repro_torch.api.Session` per request -- while still being admitted.  An
elastic ``membership`` schedule forces the event loop, which only the solo
lane runs.  Checkpointed specs (``checkpoint_every``) are solo for the same
reason chunked protocols are: their snapshots are per-run state
(``repro_torch.core.executor.run_lockstep_checkpointed``), not shared sweep cells.

The per-cell column is what makes coalescing pay off: lockstep timing is
host-side accounting and the lag executor consumes per-cell delay streams as
traced operands, so tenants probing DIFFERENT straggler scenarios against the
same problem/method template still share one compile and one dispatch.
Heterogeneous batch SIZES also share captures -- ``run_sweep_cells`` pads the
cell axis to pow2 buckets -- so the key deliberately excludes the request
count.

:func:`form_batch` applies the admission-control policy: a batch closes when
it reaches ``max_batch`` cells or the oldest member has waited ``max_wait_s``
(the service's dispatcher enforces the clock; this module is pure grouping
logic so it stays deterministic and directly testable).  Within a batch,
requests are taken round-robin ACROSS tenants (oldest-first within each
tenant), so one tenant flooding its queue cannot starve another --
per-tenant depth is additionally bounded at submit time
(:class:`repro_torch.serve.service.BackpressureError`).
"""

from __future__ import annotations

import dataclasses
from typing import Any

from repro_torch.api.spec import ExperimentSpec, MethodEntry
from repro_torch.api.sweep import SweepCellSpec, resolve_shard

#: MethodConfig fields that vary PER CELL inside a batch; everything else is
#: part of the batch key.  ``name`` is display-only (restored per request by
#: the stream demultiplexer).
CELL_FIELDS = ("name", "gamma", "sigma_prime")


@dataclasses.dataclass(frozen=True)
class CoalescePolicy:
    """Admission-control knobs for the coalescer.

    * ``max_batch`` -- close a batch at this many cells (one dispatch).
    * ``max_wait_s`` -- close a non-full batch once its oldest request has
      waited this long (latency bound under light load).
    * ``max_tenant_depth`` -- per-tenant bound on queued-but-unfinished
      requests; submissions past it are rejected with a typed
      ``BackpressureError`` instead of queueing unboundedly.
    * ``batch`` -- forwarded to ``run_sweep_cells``; the default ``"map"``
      keeps every coalesced cell bit-identical to its solo ``Session`` run
      (the serve contract); ``"vmap"`` trades that for throughput.
    * ``shard`` -- mesh sharding request, resolved per batch key.
    """

    max_batch: int = 16
    max_wait_s: float = 0.05
    max_tenant_depth: int = 8
    batch: str = "map"
    shard: str = "auto"


@dataclasses.dataclass
class Request:
    """One admitted tenant request (internal to the service)."""

    tenant: str
    spec: ExperimentSpec
    entry: MethodEntry
    handle: Any  # repro_torch.serve.streams.JobHandle
    order: int  # admission sequence number (FIFO within a tenant)
    solo_reason: str | None = None  # non-None => solo lane, why

    @property
    def cell(self) -> SweepCellSpec:
        cfg = self.entry.config
        return SweepCellSpec(cluster=self.spec.cluster, seed=self.spec.seed,
                             gamma=cfg.gamma, sigma_prime=cfg.sigma_prime)


def method_template(cfg) -> tuple:
    """The method's batch-key projection: every field except CELL_FIELDS."""
    return tuple(sorted(
        (f.name, getattr(cfg, f.name)) for f in dataclasses.fields(cfg)
        if f.name not in CELL_FIELDS))


def batch_key(spec: ExperimentSpec, entry: MethodEntry, *,
              policy: CoalescePolicy) -> tuple:
    """The coalescing key: requests with equal keys share one compiled call.

    Includes the resolved :class:`~repro_torch.api.sweep.ShardPlan` (not the raw
    ``shard`` string): ``"auto"`` and ``"cells"`` resolve identically on a
    multi-device host and must coalesce.
    """
    cfg = entry.config
    plan = resolve_shard(policy.shard, protocol=cfg.protocol,
                         num_workers=spec.cluster.num_workers, n_devices=1)
    return (
        spec.problem.kind,
        tuple(sorted(spec.problem.params.items())),
        method_template(cfg),
        entry.num_outer,
        spec.eval_every,
        policy.batch,
        plan,
        # Checkpointed specs never reach a batch (the service forces them
        # solo); keyed anyway so a future relaxation cannot silently mix
        # checkpointed and plain runs in one cohort.
        spec.checkpoint_every,
    )


def form_batch(requests: list[Request], *, max_batch: int) -> list[Request]:
    """Pick <= ``max_batch`` requests from one key group, round-robin across
    tenants (oldest-first within each tenant).

    With T waiting tenants each tenant gets ~``max_batch / T`` slots in the
    closing batch regardless of how deep any single tenant's backlog is --
    the in-batch half of the fairness story (the other half is the
    per-tenant depth bound at submit).
    """
    by_tenant: dict[str, list[Request]] = {}
    for r in sorted(requests, key=lambda r: r.order):
        by_tenant.setdefault(r.tenant, []).append(r)
    queues = [by_tenant[t] for t in sorted(by_tenant)]
    picked: list[Request] = []
    while queues and len(picked) < max_batch:
        next_round = []
        for q in queues:
            if len(picked) >= max_batch:
                break
            picked.append(q.pop(0))
            if q:
                next_round.append(q)
        queues = next_round
    return picked
