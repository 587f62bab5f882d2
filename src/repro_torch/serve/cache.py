"""Service-side caches: graph-cache mirror, result cache, dataset cache.

PyTorch counterpart of ``repro.serve.cache``.

**Graph-cache mirror.** On the card a sweep batch runs as one captured CUDA
graph, held in the executor's process-wide cache
(:func:`repro_torch.core.executor._compiled`) and replayed for every later
batch of the same signature -- a long-lived service keeps the graphs warm.
What the cache does not give a service is *observability*: whether an
incoming batch will replay a warm graph or pay a fresh capture, and so what
the fleet's capture amortization is. :class:`CompileCache` counts hits and
misses per :func:`sweep_cache_key`, which is the very key the executor files
the batch's graph under (:func:`repro_torch.api.sweep.sweep_key`): gamma and
sigma' are graph inputs, the cell axis is padded to its power-of-two bucket
and the eval snapshots to theirs, so two batches map to the same key if and
only if the second replays the first's graph (cross-checked against
``executor.STATS`` capture counters in tests/test_torch_service.py). Where
the JAX package's mirror re-derives ``jax.jit``'s key (static arguments and
operand shapes), this one reads the executor's key itself, which also names
the problem's ``X`` (its address: a rebuilt problem captures anew). The
executor keeps at most 16 graphs, so a key seen before may have been
evicted: the mirror asks the executor whether it still holds the key
(:func:`repro_torch.core.executor.holds`) and counts a batch whose graph was
evicted as a miss, as the executor counts a capture.

**Result cache.** Every run here is a pure function of its spec: identical
``(problem, cluster, method entry, seed, stop targets, executor)``
submissions replay the identical event stream.  :class:`TTLCache` keyed by
:func:`result_cache_key` therefore serves repeats without dispatching --
bit-identical by construction, since what is cached IS the delivered
``(events, result)``.  Entries age out after ``ttl_s`` on the service's
injectable clock and the least-recently-USED entry is evicted past
``max_entries`` (an LRU, not FIFO: a hot template stays warm under churn).
The same class bounds the memoized problem datasets (the build is
deterministic, so eviction only costs a rebuild).  Hit/evict counters
surface through ``ExperimentService.stats()``.
"""

from __future__ import annotations

import dataclasses
import threading
from collections import OrderedDict

from repro_torch.api import sweep as sweep_lib
from repro_torch.core import executor
from repro_torch.serve.clock import SYSTEM_CLOCK, Clock


def sweep_cache_key(problem, method, num_cells: int, *, num_outer: int,
                    eval_every: int, batch: str) -> tuple:
    """The key of the captured graph a ``run_sweep_cells`` call of this
    shape runs in (``executor.cache_key``): heterogeneous tenant batches
    that pad alike collapse to one key, and one capture."""
    return sweep_lib.sweep_key(problem, method, num_cells, num_outer=num_outer,
                               eval_every=eval_every, batch=batch)


class CompileCache:
    """Hit/miss accounting over the warm graph cache (thread-safe).

    ``note(key)`` records one batched dispatch against ``key``, just before
    it runs, and returns whether it was warm: whether the executor holds a
    live graph for the key, which the dispatch then replays.  ``stats()``
    reports the counters the bench and ``GET /stats`` surface: total
    hits/misses, distinct entries, hit rate.
    """

    def __init__(self):
        self._lock = threading.Lock()
        self._seen: dict[tuple, int] = {}
        self.hits = 0
        self.misses = 0

    def note(self, key: tuple) -> bool:
        with self._lock:
            warm = executor.holds(key)
            self._seen[key] = self._seen.get(key, 0) + 1
            if warm:
                self.hits += 1
            else:
                self.misses += 1
            return warm

    def stats(self) -> dict:
        with self._lock:
            total = self.hits + self.misses
            return {
                "entries": len(self._seen),
                "hits": self.hits,
                "misses": self.misses,
                "hit_rate": self.hits / total if total else 0.0,
            }


def warm_trace_counters() -> dict:
    """The executor's process-wide capture/run counters (ground truth the
    mirror is validated against)."""
    return {k: executor.STATS[k] for k in
            ("sweep_calls", "sweep_traces", "sweep_lag_calls",
             "sweep_lag_traces")}


# ---------------------------------------------------------------------------
# TTL + LRU value cache (results, memoized datasets).
# ---------------------------------------------------------------------------


def result_cache_key(spec, entry) -> tuple:
    """The full run identity a delivered ``(events, result)`` depends on.

    Two submissions with equal keys replay bit-identical streams (runs are
    pure functions of the spec; the batch-vs-solo parity pin in
    tests/test_torch_service.py is what makes lane-independence true), so the
    result cache may serve one from the other -- across tenants, which do
    NOT enter the key on purpose.  The service's device does not enter it:
    one service computes on one device."""
    return (
        spec.problem.kind,
        repr(sorted(spec.problem.params.items())),
        repr(dataclasses.asdict(spec.cluster)),
        repr(dataclasses.asdict(entry.config)),
        int(entry.num_outer), int(spec.seed), int(spec.eval_every),
        spec.target_gap, spec.time_budget, spec.executor,
        spec.checkpoint_every,
    )


class TTLCache:
    """Thread-safe bounded cache: TTL expiry + least-recently-USED eviction.

    ``max_entries=0`` disables the cache entirely (every ``get`` misses,
    ``put`` is a no-op) -- the service's default for RESULTS, because a
    silent result cache would invalidate dispatch-counter pins in existing
    tests and benches; callers opt in.  ``ttl_s=None`` means entries never
    expire by age.  Time comes from the injected :class:`Clock`, so expiry
    is testable with a ``ManualClock``.
    """

    def __init__(self, *, max_entries: int, ttl_s: float | None = None,
                 clock: Clock | None = None):
        if max_entries < 0:
            raise ValueError(f"max_entries must be >= 0, got {max_entries}")
        if ttl_s is not None and ttl_s <= 0:
            raise ValueError(f"ttl_s must be positive or None, got {ttl_s}")
        self.max_entries = int(max_entries)
        self.ttl_s = None if ttl_s is None else float(ttl_s)
        self.clock = clock or SYSTEM_CLOCK
        self._lock = threading.Lock()
        self._entries: OrderedDict = OrderedDict()  # key -> (value, stored_at)
        self.hits = 0
        self.misses = 0
        self.evicted_ttl = 0
        self.evicted_lru = 0

    def _expired(self, stored_at: float, now: float) -> bool:
        return self.ttl_s is not None and now - stored_at >= self.ttl_s

    def get(self, key) -> tuple[bool, object]:
        """``(hit, value)``; a hit refreshes the key's LRU position."""
        with self._lock:
            entry = self._entries.get(key)
            if entry is not None and not self._expired(entry[1],
                                                       self.clock.monotonic()):
                self._entries.move_to_end(key)
                self.hits += 1
                return True, entry[0]
            if entry is not None:  # present but stale
                del self._entries[key]
                self.evicted_ttl += 1
            self.misses += 1
            return False, None

    def put(self, key, value) -> None:
        if self.max_entries == 0:
            return
        with self._lock:
            now = self.clock.monotonic()
            self._entries[key] = (value, now)
            self._entries.move_to_end(key)
            stale = [k for k, (_, at) in self._entries.items()
                     if self._expired(at, now)]
            for k in stale:
                del self._entries[k]
                self.evicted_ttl += 1
            while len(self._entries) > self.max_entries:
                self._entries.popitem(last=False)  # least recently used
                self.evicted_lru += 1

    def __len__(self) -> int:
        with self._lock:
            return len(self._entries)

    def stats(self) -> dict:
        with self._lock:
            total = self.hits + self.misses
            return {
                "entries": len(self._entries),
                "max_entries": self.max_entries,
                "ttl_s": self.ttl_s,
                "hits": self.hits,
                "misses": self.misses,
                "hit_rate": self.hits / total if total else 0.0,
                "evicted_ttl": self.evicted_ttl,
                "evicted_lru": self.evicted_lru,
            }
