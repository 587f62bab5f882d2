"""The persistent multi-tenant experiment service.

PyTorch counterpart of ``repro.serve``, with the same exports. Batches run
through the port's sweeps (one captured CUDA graph per batch signature on
the card, every cell through the ``sdca_inner`` kernel) and solo requests
through its ``Session``, on the service's device.

Long-lived serving over the batched sweep substrate: tenants submit
:class:`~repro_torch.api.ExperimentSpec` requests (in-process or over HTTP --
``python -m repro_torch serve``); the service validates at admission, coalesces
compatible requests into shared :func:`repro_torch.api.run_sweep_cells` batches
(per-tenant round-robin fairness, bounded queue depth with typed
backpressure), keeps the graph cache warm across tenants with hit/miss
accounting, and streams each tenant's typed Round/Sync/Eval/Stop events back
bit-identical to a solo :class:`~repro_torch.api.Session` run.

The serve layer is also **self-healing**: injected or real failures
are retried with backoff when transient, quarantined by cohort bisection
when persistent, bounded by watchdog deadlines and a per-key circuit
breaker, and divergent (non-finite) cells are masked out of delivery
per-cell -- while checkpointed runs survive a service kill and resume
bit-identically.  Fault schedules come from the :mod:`repro_torch.core.faults`
registry; the knobs live in :class:`~repro_torch.serve.recovery.RecoveryPolicy`.

The serve layer also scales PAST one process: N replicas coordinate
through a shared **cluster directory** -- mutually-exclusive lease files own
jobs, heartbeats detect dead replicas, and survivors take over a dead
owner's lease and resume its checkpointed run bit-identically
(:mod:`repro_torch.serve.cluster` + :mod:`repro_torch.serve.leases`; spawn replicas with
``python -m repro_torch serve --replica-of <cluster-dir>``).  Cross-process chaos
replays exactly through the seeded network-fault family in
:mod:`repro_torch.core.faults` (drop/duplicate/reorder/delay/partition/kill).

Layout: :mod:`~repro_torch.serve.service` (admission + dispatch + recovery),
:mod:`~repro_torch.serve.coalesce` (batch keys + fairness policy),
:mod:`~repro_torch.serve.streams` (per-tenant demux/replay),
:mod:`~repro_torch.serve.recovery` (typed errors, backoff, breaker, watchdog),
:mod:`~repro_torch.serve.cache` (compile-cache mirror + TTL/LRU result cache),
:mod:`~repro_torch.serve.clock` (the injectable clock every timing decision
reads), :mod:`~repro_torch.serve.leases` (filesystem leases + heartbeats),
:mod:`~repro_torch.serve.cluster` (replicas, transport, client, takeover),
:mod:`~repro_torch.serve.http` (stdlib HTTP front end + replica CLI).
docs/serving.md and docs/fault-tolerance.md are the executed guides.
"""

from repro_torch.serve.cache import (  # noqa: F401
    CompileCache,
    TTLCache,
    result_cache_key,
    sweep_cache_key,
)
from repro_torch.serve.clock import SYSTEM_CLOCK, Clock, ManualClock  # noqa: F401
from repro_torch.serve.cluster import (  # noqa: F401
    ClusterClient,
    ClusterJobError,
    ClusterReplica,
    ClusterTransport,
    ClusterUnavailableError,
    job_key,
    run_cluster,
)
from repro_torch.serve.leases import LeaseManager  # noqa: F401
from repro_torch.serve.coalesce import (  # noqa: F401
    CoalescePolicy,
    batch_key,
    form_batch,
)
from repro_torch.serve.http import (  # noqa: F401
    event_from_dict,
    event_to_dict,
    serve_http,
)
from repro_torch.serve.recovery import (  # noqa: F401
    CellDivergenceError,
    CircuitBreaker,
    CircuitOpenError,
    JobTimeoutError,
    RecoveryPolicy,
    ServiceStoppedError,
)
from repro_torch.serve.service import (  # noqa: F401
    BackpressureError,
    ExperimentService,
    SpecValidationError,
)
from repro_torch.serve.streams import JobHandle, replay_events  # noqa: F401

__all__ = [
    "BackpressureError",
    "CellDivergenceError",
    "CircuitBreaker",
    "CircuitOpenError",
    "Clock",
    "ClusterClient",
    "ClusterJobError",
    "ClusterReplica",
    "ClusterTransport",
    "ClusterUnavailableError",
    "CoalescePolicy",
    "CompileCache",
    "ExperimentService",
    "JobHandle",
    "JobTimeoutError",
    "LeaseManager",
    "ManualClock",
    "RecoveryPolicy",
    "SYSTEM_CLOCK",
    "ServiceStoppedError",
    "SpecValidationError",
    "TTLCache",
    "batch_key",
    "event_from_dict",
    "event_to_dict",
    "form_batch",
    "job_key",
    "replay_events",
    "result_cache_key",
    "run_cluster",
    "serve_http",
    "sweep_cache_key",
]
