"""Pluggable worker-delay models: the straggler axis of the simulator.

A copy of the JAX package's pure-numpy ``repro.core.delays``, kept in the
port so that it never imports ``repro``: the same seed gives the same
streams. The engine, executors and specs named below are the JAX package's
until the port has them.

The paper's claim is that ACPD is *straggler-agnostic*, but the seed simulator
only exercised one delay shape (a deterministic per-worker slowdown with
optional lognormal jitter).  This module makes worker delay a first-class
registry, mirroring the protocol registry in ``repro.core.engine`` and the
compressor registry in ``repro.core.compress``, so every
protocol x delay x compressor scenario is one declarative
``repro.api.ExperimentSpec``.

A delay model answers three timing questions for the event loop:

* ``compute_time(k, H, rng)``   -- how long worker ``k``'s next local round of
  ``H`` solver steps takes;
* ``p2p_time(nbytes, k)``       -- how long a ``nbytes`` point-to-point
  message to/from worker ``k`` takes (``k=None`` = an unspecified link);
* ``allreduce_time(d)``         -- how long a ring all-reduce of a d-vector
  takes (synchronous protocols only).

Registry entries:

* ``constant``             -- the seed behavior, bit-for-bit: deterministic
  ``H * unit_time * sigma_k``, times a LogNormal(0, jitter) factor when
  ``ClusterModel.jitter > 0``.  This is the default; the ``group``/``sync``
  reference trajectories are pinned through it.
* ``shifted_exponential``  -- the classic straggler model (e.g. Lee et al.,
  "Speeding Up Distributed Machine Learning Using Codes"): a deterministic
  floor plus an exponential tail,
  ``t = base * (1 + Exp(tail_mean))``.
* ``pareto``               -- heavy-tailed delays: ``t = base * (1 + scale *
  Pareto(shape))``.  Small ``shape`` means occasional extreme stragglers; the
  variance is infinite for ``shape <= 2``.
* ``markov``               -- bursty stragglers: each worker carries a hidden
  fast/slow state evolving as a 2-state Markov chain per local round
  (``p_slow`` to enter, ``p_recover`` to leave, ``slow_factor`` multiplier
  while slow).  Models machines that degrade for a stretch (GC pause, noisy
  neighbor) rather than per-round iid noise.
* ``bandwidth_coupled``    -- compute is deterministic but straggler workers
  sit behind a ``link_slowdown`` x slower NIC, so their message time is
  ``latency + nbytes * link_slowdown / bandwidth``.  Delay is proportional to
  *payload bytes*, closing the loop with the compressor byte accounting: a
  sparser or quantized payload (see ``repro.core.compress``) directly
  shrinks the straggler's delay.

Sampling interfaces: the per-call ``compute_time`` above serves the event
executor's one-draw-per-launch discipline.  Two batched forms sit on top of
it.  A single ``sample_round`` call is bit-equal to K sequential
``compute_time`` calls in worker order, so every *pinned* trajectory
(``constant``, with or without jitter -- the only model the reference
oracle in :mod:`repro_torch.core.acpd` covers) is unmoved.  For ``vector_sampled``
models the group-family event loop's CONSUMPTION changed with this
interface: one size-K draw per server round indexed by worker id, replacing
per-relaunch scalars in arrival order -- group/lag trajectories under
``shifted_exponential``/``pareto`` intentionally moved (this is what makes
the stream pre-sampleable for the scan executor; the two executors remain
bit-identical to each other):

* ``sample_round(H, rng)``       -- one round's compute times for ALL K
  workers as a single vector.  The default implementation loops
  ``compute_time(k, ...)`` in worker order; ``shifted_exponential`` and
  ``pareto`` override it with ONE vectorized numpy draw of size K (bit-equal
  to K scalar draws under ``np.random.Generator``, which the tests pin) --
  the event executor uses this to replace per-message scalar draws.
* ``sample_stream(num_rounds, H, rng, lockstep=...)`` -- the whole run's
  compute times as a ``(num_rounds, K)`` matrix, pre-sampled so the
  scan-fused executor (``repro.core.executor``) can move the entire round
  loop on device.  With ``lockstep=True`` (synchronous protocols, which
  consume exactly one K-vector per round) every model can stream.  With
  ``lockstep=False`` (group-family rounds, which index the round's vector by
  worker id) a model may return ``None`` when its draws cannot be
  pre-assigned to ``(round, worker)`` cells without changing the event
  executor's stream -- ``markov`` (per-call chain advance) and ``constant``
  with jitter (per-launch draw order is pinned bit-for-bit against the
  reference loops) do so, and the executor falls back to the event queue.

``vector_sampled`` marks models whose event-executor draws are per-round
K-vectors indexed by worker id (the group-family vectorization above);
``link_factors()`` exposes per-worker link slowdowns so in-graph executors
can reproduce ``p2p_time`` arithmetic exactly.

Statefulness: most models are stateless given the run's host RNG, but
``markov`` keeps per-worker chain state.  The engine therefore builds a FRESH
model per run via :meth:`ClusterModel.make_delay` (every
``repro.core.engine.Protocol`` does this in ``__init__``), which keeps
runs reproducible from ``(spec, seed)`` alone.  The back-compat delegation
``ClusterModel.compute_time`` uses one lazily-cached instance per
``ClusterModel`` -- fine for the stateless models it exists to serve (the
reference loops in :mod:`repro_torch.core.acpd` only support ``constant``).

Extending: subclass :class:`DelayModel`, decorate with
:func:`register_delay`, accept your parameters as keyword arguments (they
arrive from ``ClusterModel.delay_params``, so they must be JSON scalars).
See ``docs/extending-protocols.md`` for the sibling protocol walkthrough.
"""

from __future__ import annotations

import math

import numpy as np

# ---------------------------------------------------------------------------
# Registry.
# ---------------------------------------------------------------------------

_DELAYS: dict[str, type["DelayModel"]] = {}


def register_delay(name: str):
    """Class decorator: make a DelayModel constructible via
    ``ClusterModel.delay_model``."""

    def deco(cls: type["DelayModel"]) -> type["DelayModel"]:
        cls.delay_name = name
        _DELAYS[name] = cls
        return cls

    return deco


def available_delays() -> tuple[str, ...]:
    return tuple(sorted(_DELAYS))


def get_delay(name: str) -> type["DelayModel"]:
    try:
        return _DELAYS[name]
    except KeyError:
        raise ValueError(
            f"unknown delay model {name!r}; available: {available_delays()}"
        ) from None


# ---------------------------------------------------------------------------
# Base class.
# ---------------------------------------------------------------------------


class DelayModel:
    """Per-run timing model; see the module docstring for the contract.

    ``cluster`` is the owning :class:`repro_torch.core.simulate.ClusterModel`; its
    ``unit_time`` / ``sigmas()`` / ``latency`` / ``bandwidth`` fields are the
    shared vocabulary every model builds on.  ``base_compute(k, H)`` is the
    deterministic floor ``H * unit_time * sigma_k`` that stochastic models
    decorate with their tail.
    """

    delay_name = "abstract"
    # True for models carrying mutable per-run state (e.g. markov chains).
    # Stateful models are only reachable through ClusterModel.make_delay();
    # the legacy ClusterModel.compute_time delegation refuses them, since its
    # cached instance would silently leak state across runs.
    stateful = False
    # True for models whose message timing depends on WHICH worker is on the
    # link.  The legacy ClusterModel.p2p_time signature cannot carry the
    # worker index, so the delegation refuses these too rather than silently
    # timing every worker on the fast link.
    worker_aware = False
    # True once the model's event-executor draws are per-round K-vectors
    # indexed by worker id (vectorized ``sample_round``); the group-family
    # event loop then draws ONE vector per server round instead of one
    # scalar per relaunched worker, and the scan executor can pre-sample the
    # identical (round, worker) stream.
    vector_sampled = False

    def __init__(self, cluster):
        self.cluster = cluster
        self._sigmas = cluster.sigmas()

    def base_compute(self, k: int, H: int) -> float:
        # Same expression (and therefore the same floats) as the seed's
        # ClusterModel.compute_time.
        return H * self.cluster.unit_time * self._sigmas[k]

    def base_compute_vector(self, H: int) -> np.ndarray:
        """``base_compute`` for all K workers; same floats elementwise."""
        return H * self.cluster.unit_time * self._sigmas

    # -- the three timing hooks -------------------------------------------

    def compute_time(self, k: int, H: int, rng: np.random.Generator) -> float:
        raise NotImplementedError

    def p2p_time(self, nbytes: int, k: int | None = None) -> float:
        return self.cluster.latency + nbytes / self.cluster.bandwidth

    def allreduce_time(self, d: int, value_bytes: int = 4) -> float:
        return self.cluster.allreduce_time(d, value_bytes)

    # -- batched sampling (module docstring: "Sampling interfaces") --------

    def sample_round(self, H: int, rng: np.random.Generator) -> np.ndarray:
        """One round's compute times for all K workers, worker order.

        Default: K sequential ``compute_time`` calls -- byte-identical RNG
        stream to the per-call form.  Vectorized overrides must keep that
        stream (one size-K draw == K scalar draws under numpy Generators).
        """
        return np.asarray([self.compute_time(k, H, rng)
                           for k in range(self.cluster.num_workers)])

    def sample_stream(self, num_rounds: int, H: int,
                      rng: np.random.Generator, *,
                      lockstep: bool = False) -> np.ndarray | None:
        """Pre-sample the whole run: ``(num_rounds, K)`` compute times.

        ``lockstep=True``: the consumer burns exactly one K-vector per round
        in worker order (synchronous protocols) -- always available, any
        model, same stream as the event executor.  ``lockstep=False``: the
        consumer indexes cell ``(round, worker)`` on demand (group-family
        rounds); only available when that assignment reproduces the event
        executor's stream -- i.e. the model is ``vector_sampled`` or fully
        deterministic -- otherwise ``None`` (caller falls back to events).
        """
        if not lockstep and not (self.vector_sampled or self.deterministic):
            return None
        return np.stack([self.sample_round(H, rng)
                         for _ in range(num_rounds)])

    def sample_chunks(self, chunk_steps: tuple[int, ...],
                      rng: np.random.Generator) -> np.ndarray:
        """One chunked round's compute times: ``(n_chunks, K)``, chunk-major.

        Chunk-streaming protocols (``partial_work``) split one local pass of
        ``H`` steps into ``chunk_steps`` pieces; each chunk's duration is an
        independent ``sample_round`` draw at that chunk's step count, taken
        chunk-major so that with ONE chunk the draw is exactly the single
        ``sample_round(H)`` the group family makes -- the bit-identity the
        ``n_chunks=1`` degradation tests pin.
        """
        return np.stack([self.sample_round(h, rng) for h in chunk_steps])

    def sample_chunk_stream(self, num_waves: int, chunk_steps: tuple[int, ...],
                            rng: np.random.Generator) -> np.ndarray | None:
        """Pre-sample ``num_waves`` chunked launch waves:
        ``(num_waves, n_chunks, K)``, or ``None`` when per-``(wave, chunk,
        worker)`` cells cannot reproduce the event executor's stream (same
        eligibility rule as non-lockstep ``sample_stream``)."""
        if not (self.vector_sampled or self.deterministic):
            return None
        return np.stack([self.sample_chunks(chunk_steps, rng)
                         for _ in range(num_waves)])

    @property
    def deterministic(self) -> bool:
        """True when ``compute_time`` never touches the RNG."""
        return False

    def link_factors(self) -> np.ndarray:
        """Per-worker link slowdown factors f_k such that
        ``p2p_time(nbytes, k) == latency + nbytes * f_k / bandwidth`` --
        the exact arithmetic in-graph executors replicate."""
        return np.ones(self.cluster.num_workers)


@register_delay("constant")
class ConstantDelay(DelayModel):
    """The seed model, bit-for-bit: deterministic sigma_k slowdown, optional
    LogNormal(0, jitter) multiplicative noise (drawn only when jitter > 0, so
    the host-RNG draw order matches the pinned reference trajectories)."""

    def compute_time(self, k, H, rng):
        base = self.base_compute(k, H)
        if self.cluster.jitter > 0.0:
            base *= float(rng.lognormal(0.0, self.cluster.jitter))
        return base

    @property
    def deterministic(self):
        # Jitter-free constant delays never consume the RNG, so the whole
        # stream is pre-sampleable for any consumption order.
        return self.cluster.jitter == 0.0


@register_delay("shifted_exponential")
class ShiftedExponentialDelay(DelayModel):
    """Deterministic floor + exponential tail: ``base * (1 + Exp(tail_mean))``.

    ``tail_mean`` is the mean of the exponential tail as a fraction of the
    deterministic base, so the expected round time is ``base * (1 +
    tail_mean)`` and no sample is ever faster than ``base``.
    """

    vector_sampled = True

    def __init__(self, cluster, *, tail_mean: float = 0.5):
        super().__init__(cluster)
        if tail_mean < 0:
            raise ValueError(f"tail_mean must be >= 0, got {tail_mean}")
        self.tail_mean = tail_mean

    def compute_time(self, k, H, rng):
        base = self.base_compute(k, H)
        return base * (1.0 + float(rng.exponential(self.tail_mean)))

    def sample_round(self, H, rng):
        # One size-K draw; numpy Generators make it bit-equal to K scalar
        # draws (pinned by tests/test_delays.py), so per-call and per-round
        # consumers see the same stream.
        K = self.cluster.num_workers
        return self.base_compute_vector(H) * (
            1.0 + rng.exponential(self.tail_mean, size=K))


@register_delay("pareto")
class ParetoDelay(DelayModel):
    """Heavy-tailed delays: ``base * (1 + scale * Pareto(shape))``.

    ``numpy``'s ``rng.pareto(a)`` samples the Lomax form (support ``[0,
    inf)``, mean ``1/(a-1)`` for ``a > 1``), so the expected round time is
    ``base * (1 + scale / (shape - 1))`` -- but unlike the exponential tail,
    extreme stragglers occur at polynomial (not exponential) rarity.
    """

    vector_sampled = True

    def __init__(self, cluster, *, shape: float = 2.5, scale: float = 0.25):
        super().__init__(cluster)
        if shape <= 0 or scale < 0:
            raise ValueError(
                f"need shape > 0 and scale >= 0, got {shape}, {scale}")
        self.shape = shape
        self.scale = scale

    def compute_time(self, k, H, rng):
        base = self.base_compute(k, H)
        return base * (1.0 + self.scale * float(rng.pareto(self.shape)))

    def sample_round(self, H, rng):
        K = self.cluster.num_workers
        return self.base_compute_vector(H) * (
            1.0 + self.scale * rng.pareto(self.shape, size=K))


@register_delay("markov")
class MarkovDelay(DelayModel):
    """Bursty stragglers: a hidden 2-state (fast/slow) Markov chain per worker.

    Each ``compute_time`` call advances worker ``k``'s chain one step:
    a fast worker turns slow with probability ``p_slow``; a slow worker
    recovers with probability ``p_recover``; while slow, compute is
    ``slow_factor`` x the base.  Stationary slow fraction =
    ``p_slow / (p_slow + p_recover)``; mean burst length = ``1 / p_recover``
    rounds.  Stateful -- use a fresh instance per run
    (:meth:`ClusterModel.make_delay`, which the engine protocols do).
    """

    stateful = True

    def __init__(self, cluster, *, p_slow: float = 0.1, p_recover: float = 0.3,
                 slow_factor: float = 5.0):
        super().__init__(cluster)
        for nm, p in (("p_slow", p_slow), ("p_recover", p_recover)):
            if not 0.0 <= p <= 1.0:
                raise ValueError(f"{nm} must be in [0, 1], got {p}")
        if slow_factor <= 0:
            raise ValueError(f"slow_factor must be > 0, got {slow_factor}")
        self.p_slow = p_slow
        self.p_recover = p_recover
        self.slow_factor = slow_factor
        self.slow = np.zeros(cluster.num_workers, dtype=bool)

    def compute_time(self, k, H, rng):
        u = rng.random()
        if self.slow[k]:
            if u < self.p_recover:
                self.slow[k] = False
        elif u < self.p_slow:
            self.slow[k] = True
        base = self.base_compute(k, H)
        return base * (self.slow_factor if self.slow[k] else 1.0)


@register_delay("bandwidth_coupled")
class BandwidthCoupledDelay(ConstantDelay):
    """Stragglers are slow LINKS, not slow CPUs: message time scales with the
    actual payload bytes over a per-worker link speed.

    Workers in ``ClusterModel.straggler_workers`` sit behind a
    ``link_slowdown`` x slower NIC; everyone's compute follows the
    ``constant`` model with ``sigma_k = 1`` semantics left to the cluster's
    own fields.  Because delay is billed on the same ``nbytes`` the
    compressor's ``wire_bytes``/``payload_bytes`` accounting produced, a
    sparser or quantized payload directly shrinks the straggler's delay --
    the compressor <-> delay coupling the paper's communication-efficiency
    argument is about.
    """

    worker_aware = True

    def __init__(self, cluster, *, link_slowdown: float = 10.0):
        super().__init__(cluster)
        if link_slowdown <= 0:
            raise ValueError(f"link_slowdown must be > 0, got {link_slowdown}")
        self.link_slowdown = link_slowdown
        self._slow = np.ones(cluster.num_workers)
        for k in cluster.straggler_workers:
            if 0 <= k < cluster.num_workers:
                self._slow[k] = link_slowdown

    def p2p_time(self, nbytes, k=None):
        factor = 1.0 if k is None else self._slow[k]
        return self.cluster.latency + nbytes * factor / self.cluster.bandwidth

    def link_factors(self):
        return self._slow.copy()

    def allreduce_time(self, d, value_bytes=4):
        # A ring all-reduce moves at the pace of its slowest link.
        c = self.cluster
        K = c.num_workers
        if K <= 1:
            return 0.0
        ring = 2.0 * (K - 1) / K * d * value_bytes / c.bandwidth
        return (ring * float(self._slow.max())
                + 2.0 * math.ceil(math.log2(K)) * c.latency)
