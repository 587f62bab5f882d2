"""Event clock for the simulated distributed environment (Sec. V-B of the paper).

A copy of the JAX package's pure-numpy ``repro.core.simulate``, kept in the
port so that it never imports ``repro``.

The paper simulates stragglers by making worker 1 take ``sigma`` times the
normal per-round compute time, and separately runs in a "real" cluster where
speeds jitter randomly. We model both:

* compute time of worker k per local round:  H * unit_time * sigma_k * J
  where J ~ LogNormal(0, jitter) (jitter=0 -> deterministic, the Sec. V-B setup).
* point-to-point message time:               latency + bytes / bandwidth
* ring all-reduce of a d-vector over K:      2 (K-1)/K * d*4 / bandwidth + 2 ceil(log2 K) * latency
  (used when timing the CoCoA+/CoCoA baselines, which the paper ran with MPI
  ``allreduce``).

All times are in arbitrary "unit" seconds; only ratios matter for the paper's
claims (speedup of ACPD over CoCoA+ at a given duality gap).
"""

from __future__ import annotations

import dataclasses
import functools
import math
from typing import Mapping

import numpy as np


@dataclasses.dataclass(frozen=True)
class ClusterModel:
    """Timing model for K workers + a server.

    ``delay_model`` names an entry in the :mod:`repro_torch.core.delays` registry
    (``constant`` reproduces the historical behavior bit-for-bit);
    ``delay_params`` are that model's keyword arguments, normalized to a
    sorted tuple of ``(name, value)`` pairs so the dataclass stays hashable
    and JSON specs round-trip to equal objects.  Protocol engines call
    :meth:`make_delay` for a FRESH model per run (required for stateful
    models like ``markov``); the ``compute_time``/``p2p_time`` methods below
    delegate to one lazily-cached instance for back-compat callers (the
    reference loops in :mod:`repro_torch.core.acpd`).
    """

    num_workers: int
    unit_time: float = 1e-5  # seconds per local SDCA iteration on a normal worker
    straggler_sigma: float = 1.0  # worker 0 is sigma x slower (paper's sigma)
    straggler_workers: tuple[int, ...] = (0,)
    jitter: float = 0.0  # lognormal sd of multiplicative compute noise
    latency: float = 1e-3  # per-message latency (seconds)
    bandwidth: float = 1.25e8  # bytes/sec (~1 Gb Ethernet, t2.medium-ish)
    delay_model: str = "constant"  # repro_torch.core.delays registry entry
    delay_params: tuple = ()  # model kwargs as (name, value) pairs (or a dict)
    # Elastic membership schedule: ``(worker, drop_time, rejoin_time)``
    # triples in simulated seconds (``rejoin_time=None`` = never rejoins).
    # A dropped worker is masked out of aggregation and stops accruing
    # bytes/compute until its rejoin.  Only protocols declaring
    # ``supports_membership`` accept a non-empty schedule (Protocol.__init__
    # rejects it loudly otherwise).
    membership: tuple = ()

    def __post_init__(self):
        params = self.delay_params
        if isinstance(params, Mapping):
            params = params.items()
        object.__setattr__(
            self, "delay_params",
            tuple(sorted((str(k), v) for k, v in params)))
        norm = []
        for entry in self.membership:
            k, drop, rejoin = entry
            norm.append((int(k), float(drop),
                         None if rejoin is None else float(rejoin)))
        object.__setattr__(self, "membership", tuple(sorted(
            norm, key=lambda e: (e[1], e[0]))))

    def sigmas(self) -> np.ndarray:
        s = np.ones(self.num_workers)
        for k in self.straggler_workers:
            if 0 <= k < self.num_workers:
                s[k] = self.straggler_sigma
        return s

    def live_at(self, k: int, t: float) -> bool:
        """Is worker ``k`` a cluster member at simulated time ``t``?

        A worker is dead during ``[drop, rejoin)`` of any of its membership
        entries (``rejoin=None`` = forever).
        """
        for w, drop, rejoin in self.membership:
            if w == k and drop <= t and (rejoin is None or t < rejoin):
                return False
        return True

    def next_drop_after(self, k: int, t: float) -> float:
        """The first drop time of worker ``k`` strictly after ``t``
        (``inf`` when it never drops again)."""
        drops = [drop for w, drop, _ in self.membership
                 if w == k and drop > t]
        return min(drops) if drops else math.inf

    def next_rejoin_after(self, t: float) -> float:
        """The earliest rejoin time strictly after ``t`` across all workers
        (``inf`` if none) -- the starvation horizon for elastic protocols."""
        rejoins = [r for _, _, r in self.membership
                   if r is not None and r > t]
        return min(rejoins) if rejoins else math.inf

    def make_delay(self):
        """A fresh :class:`repro_torch.core.delays.DelayModel` for one run."""
        from repro_torch.core import delays

        return delays.get_delay(self.delay_model)(
            self, **dict(self.delay_params))

    @functools.cached_property
    def _delay(self):
        """Lazily-cached model backing the legacy method API below.

        Stateless models only: a cached stateful model (``markov``) would
        silently leak chain state across runs sharing this ClusterModel, so
        it is refused here -- callers needing one go through
        :meth:`make_delay` per run (the engine protocols do; the reference
        loops in :mod:`repro_torch.core.acpd` support stateless models only).
        """
        model = self.make_delay()
        if model.stateful:
            raise ValueError(
                f"delay model {self.delay_model!r} is stateful; the legacy "
                f"ClusterModel.compute_time/p2p_time delegation would share "
                f"its state across runs. Use ClusterModel.make_delay() per "
                f"run (engine protocols do this automatically).")
        if model.worker_aware:
            raise ValueError(
                f"delay model {self.delay_model!r} times messages per "
                f"worker; the legacy ClusterModel.p2p_time signature cannot "
                f"carry the worker index and would silently time every "
                f"worker on the fast link. Use ClusterModel.make_delay() "
                f"(engine protocols do this automatically).")
        return model

    def compute_time(self, k: int, H: int, rng: np.random.Generator) -> float:
        return self._delay.compute_time(k, H, rng)

    def p2p_time(self, num_bytes: int) -> float:
        return self._delay.p2p_time(num_bytes)

    def allreduce_time(self, d: int, value_bytes: int = 4) -> float:
        K = self.num_workers
        if K <= 1:
            return 0.0
        ring = 2.0 * (K - 1) / K * d * value_bytes / self.bandwidth
        return ring + 2.0 * math.ceil(math.log2(K)) * self.latency


@dataclasses.dataclass
class EventClock:
    """Tracks simulated wall-clock per worker and at the server."""

    num_workers: int
    now: float = 0.0

    def __post_init__(self) -> None:
        self.worker_free_at = np.zeros(self.num_workers)

    def start_compute(self, k: int, start: float, duration: float) -> float:
        finish = max(start, self.worker_free_at[k]) + duration
        self.worker_free_at[k] = finish
        return finish

    def advance(self, t: float) -> None:
        self.now = max(self.now, t)
