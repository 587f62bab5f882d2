"""Run contracts: the executor's dispatch invariants, read off real runs.

PyTorch counterpart of ``repro.analysis.contracts``, under the JAX
package's contract names. Where the JAX module lowers the traced entry
points and reads the jaxpr and HLO, PyTorch has neither: the port's whole
run is a plain torch function captured once as a CUDA graph
(:mod:`repro_torch.core.executor`). So each contract runs the port's own
entry points on a tiny problem (the JAX package's sizes: K=2 workers,
n_k=3, d=4, R=3 rounds) and reads what the executor records:

* ``lockstep-scan-fusion`` / ``lag-scan-fusion`` -- a run of R rounds
  through :func:`repro_torch.core.executor.run_scan` is one capture
  (``STATS["*_traces"]`` +1, ``STATS["*_calls"]`` +1); a second run of the
  same signature captures nothing; the kernels a run launches are linear in
  R: R and 2R differ by exactly R rounds' worth, and nothing else launches
  but (LAG) the t=0 wave of all K workers, one launch. On the card the
  launches are the capture's (``executor.last_graph(stat).launches``); on
  the CPU, where the run is eager, the kernels' plain-version calls inside
  an ``ops.recording_launches`` block.
* ``lockstep-no-host-callbacks`` / ``lag-no-host-callbacks`` -- nothing in
  the captured body waits for the device. On the CPU the body runs under a
  ``TorchDispatchMode`` that records every device->host read
  (``aten._local_scalar_dense``: ``.item()``, ``float()``, ``bool()``, a
  tensor in an ``if``), every op whose output shape depends on the data
  (``nonzero``, ``bincount``, ``unique``, ``masked_select``, a boolean
  mask index) and every copy to the CPU; the kernels' plain versions,
  which stand in for one launch, are not the body's. (A tensor made from
  host data is the lint's to find: on the CPU it cannot be told from the
  host-side scalar math the body may do.) On the card: the capture, then
  two replays with ``executor.REPLAY_SYNC_DEBUG = "error"``, raise nothing.
* ``donation-_worker_rounds_fused`` / ``donation-_lag_window_append`` -- the
  port's counterparts of the JAX package's donated jits update their carries
  in place: ``engine.group_local_finish``'s ``alpha``, ``engine.reply``'s
  ``w_local`` and ``dw_tilde``, ``engine.lag_window_append``'s ``ref_buf``
  and ``ref_len`` keep their storage and equal an out-of-place computation
  bit for bit.
* ``donation-_server_apply_fused`` -- by design the port's ``aggregate``,
  ``aggregate_masked`` and ``apply_snapshots`` return NEW tensors: an eval
  snapshot (``engine._Snapshot``) holds ``w_server`` by reference. The
  contract checks that design (new storage, inputs untouched).
* ``sweep-bucket-cache-sharing`` -- a 3-cell grid with 3 eval boundaries and
  a 4-cell grid with 4 have equal ``api.sweep.sweep_key``s (no capture
  needed), and after running the first, the executor holds the second's
  graph and running it captures nothing.

:func:`run_contracts` runs on the CUDA device unless ``device="cpu"`` is
given, and raises without a card when none is named, as every entry point
of the port does. Each check returns :class:`ContractResult`\\ s; the CLI
fails on any ``ok=False``.
"""

from __future__ import annotations

import dataclasses
import math
import pathlib
import sys

import numpy as np
import torch
from torch.utils._python_dispatch import TorchDispatchMode

from repro_torch.api import sweep as sweep_lib
from repro_torch.core import baselines, engine, executor, objectives
from repro_torch.core import compress as compress_lib
from repro_torch.core.simulate import ClusterModel
from repro_torch.device import resolve_device
from repro_torch.kernels import ops, ref

# ---------------------------------------------------------------------------
# Results.
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class ContractResult:
    """One run-contract verdict."""

    name: str
    ok: bool
    detail: str

    def format(self) -> str:
        mark = "ok" if self.ok else "FAIL"
        return f"contract {self.name}: {mark} -- {self.detail}"

    def as_dict(self) -> dict:
        return dataclasses.asdict(self)


# ---------------------------------------------------------------------------
# Host-sync recording (the CPU's view of a capture).
# ---------------------------------------------------------------------------

# aten ops (by overload packet name) that read the device from the host or
# whose output shape depends on the data: each syncs on the card.
SYNC_OPS = {
    "_local_scalar_dense": "a device->host read (.item(), float(), int(), bool())",
    "nonzero": "a data-dependent shape (nonzero)",
    "bincount": "a data-dependent shape (bincount)",
    "unique": "a data-dependent shape (unique)",
    "_unique": "a data-dependent shape (unique)",
    "_unique2": "a data-dependent shape (unique)",
    "unique_dim": "a data-dependent shape (unique)",
    "unique_consecutive": "a data-dependent shape (unique_consecutive)",
    "masked_select": "a data-dependent shape (masked_select)",
}
_GRAPHED_CALL = executor.Graphed.__call__.__code__
_KERNELS_DIR = pathlib.Path(ops.__file__).resolve().parent
_REF_FILE = pathlib.Path(ref.__file__).resolve()


def _sync_reason(func, args, kwargs) -> str | None:
    name = func.overloadpacket.__name__
    if name in SYNC_OPS:
        return SYNC_OPS[name]
    if name == "index" and len(args) > 1 and any(
            isinstance(i, torch.Tensor) and i.dtype in (torch.bool, torch.uint8)
            for i in (args[1] or ())):
        return "a data-dependent shape (a boolean mask index)"
    if name == "_to_copy" and kwargs.get("device") is not None:
        src = args[0].device if args and isinstance(args[0], torch.Tensor) else None
        if torch.device(kwargs["device"]).type == "cpu" and src is not None \
                and src.type != "cpu":
            return "a copy to the host"
    return None


def _in_captured_body() -> bool:
    """Is the caller inside a run body that the card captures? Walks the
    stack outward: a kernel's plain version (it stands in for one launch)
    before ``Graphed.__call__`` means no."""
    frame = sys._getframe(1)
    while frame is not None:
        code = frame.f_code
        if code is _GRAPHED_CALL:
            return True
        path = pathlib.Path(code.co_filename).resolve()
        if path == _REF_FILE or (path.parent == _KERNELS_DIR
                                 and code.co_name.endswith("_plain")):
            return False
        frame = frame.f_back
    return False


class HostSyncRecorder(TorchDispatchMode):
    """Records, as ``(aten op, why)``, every op of a captured run body that
    would sync on the card (see :data:`SYNC_OPS`)."""

    def __init__(self):
        super().__init__()
        self.events: list[tuple[str, str]] = []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        why = _sync_reason(func, args, kwargs)
        if why is not None and _in_captured_body():
            self.events.append((str(func), why))
        return func(*args, **kwargs)


# ---------------------------------------------------------------------------
# Tiny problem (shared by all checks): the JAX package's sizes.
# ---------------------------------------------------------------------------

_K, _NK, _D, _R = 2, 3, 4, 3
_H = 2  # coordinate steps a worker round
_LAM = 0.1


def toy_problem(device) -> objectives.Problem:
    """K=2 workers of n_k=3 rows, d=4, smoothed hinge, from seed 0."""
    rng = np.random.default_rng(0)
    X = rng.standard_normal((_K, _NK, _D)).astype(np.float32)
    y = np.where(rng.standard_normal((_K, _NK)) >= 0, 1.0, -1.0).astype(np.float32)
    dev = torch.device(device)
    return objectives.Problem(torch.from_numpy(X).to(dev), torch.from_numpy(y).to(dev),
                              _LAM, "smoothed_hinge")


# ---------------------------------------------------------------------------
# The checks.
# ---------------------------------------------------------------------------


def _launch_counts(run, stat: str, dev: torch.device) -> dict[str, int]:
    """Run ``run()``; the kernel launches one run of it makes: the captured
    graph's on the card, the plain-version calls of its eager body on the
    CPU."""
    if dev.type == "cuda":
        run()
        return dict(executor.last_graph(stat).launches)
    with ops.recording_launches() as counts:
        run()
    return dict(counts)


def _linear(counts_a: dict, counts_b: dict, R_a: int, R_b: int,
            intercept: int) -> tuple[bool, dict[str, int]]:
    """Launches per round of each kernel, and whether every kernel's count
    is ``per_round * R`` (plus ``intercept`` launches for the kernel that
    runs the rounds, sdca_inner) at both round counts."""
    per_round, ok = {}, True
    for name in counts_a:
        base = intercept if name == "sdca_inner" else 0
        step, rest = divmod(counts_b[name] - counts_a[name], R_b - R_a)
        per_round[name] = step
        ok &= rest == 0 and counts_a[name] == base + step * R_a
    return ok and per_round.get("sdca_inner", 0) >= 1, per_round


def _fusion_contracts(prefix: str, stat: str, run, rounds, intercept: int,
                      dev: torch.device, what: str) -> list[ContractResult]:
    """The fusion and host-callback contracts of one executor path. ``run(R)``
    runs R rounds; the cache is cleared first, so R's first run captures."""
    R_a, R_b = rounds
    executor.clear_cache()
    traces, calls = f"{stat}_traces", f"{stat}_calls"
    t0, c0 = executor.STATS[traces], executor.STATS[calls]
    counts_a = _launch_counts(lambda: run(R_a), stat, dev)
    t1, c1 = executor.STATS[traces], executor.STATS[calls]
    # The same signature again: no capture. On the CPU under the recorder;
    # on the card two replays under sync debug mode "error".
    sync_error, events = None, []
    if dev.type == "cuda":
        prev = executor.REPLAY_SYNC_DEBUG
        executor.REPLAY_SYNC_DEBUG = "error"
        try:
            for _ in range(2):
                run(R_a)
            torch.cuda.synchronize(dev)
        except RuntimeError as e:
            sync_error = str(e).splitlines()[0]
        finally:
            executor.REPLAY_SYNC_DEBUG = prev
    else:
        recorder = HostSyncRecorder()
        with recorder:
            run(R_a)
        events = recorder.events
    t2, c2 = executor.STATS[traces], executor.STATS[calls]
    counts_b = _launch_counts(lambda: run(R_b), stat, dev)
    t3, c3 = executor.STATS[traces], executor.STATS[calls]
    graph = executor.last_graph(stat)

    captures = [t1 - t0, t2 - t1, t3 - t2]
    runs = [c1 - c0, c2 - c1, c3 - c2]
    linear, per_round = _linear(counts_a, counts_b, R_a, R_b, intercept)
    again = 2 if dev.type == "cuda" else 1
    ok = captures == [1, 0, 1] and runs == [1, again, 1] and linear
    capture_ms = (f", capture {graph.capture_ms:.1f} ms at R={R_b}"
                  if graph is not None and dev.type == "cuda" else "")
    out = [ContractResult(
        f"{prefix}-scan-fusion", ok,
        f"captures {captures} and runs {runs} for R={R_a}, R={R_a} again, R={R_b} "
        f"(want [1, 0, 1], [1, {again}, 1]: one graph per run signature); "
        f"launches {counts_a} at R={R_a}, {counts_b} at R={R_b}: {per_round} a "
        f"round{what}{capture_ms}")]
    if dev.type == "cuda":
        ok = sync_error is None
        detail = ("the capture and two replays under REPLAY_SYNC_DEBUG='error' "
                  "made no host sync" if ok else f"a replay synced: {sync_error}")
    else:
        ok = not events
        detail = ("the captured body made no device->host read, data-dependent "
                  "shape or host copy" if ok else
                  f"host syncs in the captured body: {sorted(set(events))}")
    out.append(ContractResult(f"{prefix}-no-host-callbacks", ok, detail))
    return out


def check_lockstep_contracts(device=None, *, problem=None, H: int = _H,
                             rounds=(_R, 2 * _R)) -> list[ContractResult]:
    """The lockstep path (CoCoA+, the ``sync`` protocol on ``sdca``): one
    capture per signature, one launch a round, no host sync."""
    dev = resolve_device(device)
    problem = toy_problem(dev) if problem is None else problem
    K = problem.X.shape[0]
    method = baselines.cocoa_plus(K, H=H)
    cluster = ClusterModel(K)

    def run(R):
        executor.run_scan(problem, method, cluster, num_outer=R, seed=0, eval_every=1)

    return _fusion_contracts("lockstep", "lockstep", run, rounds, 0, dev, "")


def check_lag_contracts(device=None, *, problem=None, H: int = _H,
                        rounds=(_R, 2 * _R)) -> list[ContractResult]:
    """The LAG queue (B = K/2 of K, T = R, dense messages as in the JAX
    package's contract): the t=0 wave of K plus R rounds in one capture."""
    dev = resolve_device(device)
    problem = toy_problem(dev) if problem is None else problem
    K, _, d = problem.X.shape
    T = math.gcd(*rounds)
    method = baselines.acpd_lag(K, d, B=max(1, K // 2), T=T, rho_d=d, H=H,
                                lag_window=2)
    cluster = ClusterModel(K)

    def run(R):
        executor.run_scan(problem, method, cluster, num_outer=R // T, seed=0,
                          eval_every=1)

    return _fusion_contracts("lag", "lag", run, rounds, 1, dev,
                             f" after the t=0 wave of K={K} (one launch), T={T}")


def _storage(t: torch.Tensor) -> int:
    return t.untyped_storage().data_ptr()


def check_engine_donation(device=None) -> list[ContractResult]:
    """The carries the port updates in place, and the server state it does
    not (see the module docstring)."""
    dev = resolve_device(device)
    gen = torch.Generator().manual_seed(0)

    def rand(*shape):
        return torch.randn(*shape, generator=gen).to(dev)

    K, n_k, d, W = _K, _NK, _D, 2
    widx = torch.tensor([1], dtype=torch.int64).to(dev)
    gamma = torch.tensor(0.5, dtype=torch.float32).to(dev)
    out = []

    # group_local_finish's alpha; reply's w_local and dw_tilde.
    alpha, dalpha, residual, v = rand(K, n_k), rand(1, n_k), rand(1, d), rand(1, d)
    want_alpha = alpha.clone()
    want_alpha[1] = alpha[1] + gamma * dalpha[0]
    ptr = _storage(alpha)
    engine.group_local_finish(alpha, widx, residual, dalpha, v, gamma,
                              compress_lib.Dense(rho=1.0))
    w_local, dw_tilde = rand(K, d), rand(K, d)
    want_w, want_dw = w_local.clone(), dw_tilde.clone()
    want_w[1] = w_local[1] + dw_tilde[1]
    want_dw[1] = 0.0
    ptrs = (_storage(w_local), _storage(dw_tilde))
    engine.reply(w_local, dw_tilde, widx)
    same = {"alpha": ptr == _storage(alpha),
            "w_local": ptrs[0] == _storage(w_local),
            "dw_tilde": ptrs[1] == _storage(dw_tilde)}
    equal = {"alpha": torch.equal(alpha, want_alpha), "w_local": torch.equal(w_local, want_w),
             "dw_tilde": torch.equal(dw_tilde, want_dw)}
    out.append(ContractResult(
        "donation-_worker_rounds_fused", all(same.values()) and all(equal.values()),
        f"group_local_finish / reply carries keep their storage {same} and equal "
        f"the out-of-place result bit for bit {equal}"))

    # lag_window_append's ref_buf and ref_len: worker 0's window is full
    # (shift, then append), worker 1's is not (append).
    ref_buf = rand(K, W)
    ref_len = torch.tensor([W, 1], dtype=torch.int32).to(dev)
    both = torch.tensor([1, 0], dtype=torch.int64).to(dev)
    reply_sq = rand(2)
    want_buf, want_len = ref_buf.clone(), ref_len.clone()
    for j, k in enumerate((1, 0)):
        length = int(ref_len[k])
        if length >= W:
            want_buf[k] = torch.cat([ref_buf[k, 1:], reply_sq[j:j + 1]])
        else:
            want_buf[k, length] = reply_sq[j]
        want_len[k] = min(length + 1, W)
    ptrs = (_storage(ref_buf), _storage(ref_len))
    engine.lag_window_append(ref_buf, ref_len, both, reply_sq)
    same = {"ref_buf": ptrs[0] == _storage(ref_buf), "ref_len": ptrs[1] == _storage(ref_len)}
    equal = {"ref_buf": torch.equal(ref_buf, want_buf),
             "ref_len": torch.equal(ref_len, want_len)}
    out.append(ContractResult(
        "donation-_lag_window_append", all(same.values()) and all(equal.values()),
        f"lag_window_append carries keep their storage {same} and equal the "
        f"out-of-place result bit for bit {equal}"))

    # The server apply returns new tensors and leaves its inputs as they were.
    w_server, dw_all, alpha_applied = rand(d), rand(K, d), rand(K, n_k)
    payloads, take = [rand(d), rand(d)], [torch.tensor(True).to(dev),
                                          torch.tensor(False).to(dev)]
    before = [t.clone() for t in (w_server, dw_all, alpha_applied)]
    results = (engine.aggregate(w_server, dw_all, payloads, gamma)
               + engine.aggregate_masked(w_server, dw_all, payloads, take, gamma)
               + (engine.apply_snapshots(alpha_applied, widx, rand(1, n_k),
                                         torch.tensor([True]).to(dev)),))
    inputs = {_storage(t) for t in (w_server, dw_all, alpha_applied)}
    fresh = all(_storage(r) not in inputs for r in results)
    untouched = all(torch.equal(a, b) for a, b in zip(before, (w_server, dw_all,
                                                                alpha_applied)))
    out.append(ContractResult(
        "donation-_server_apply_fused", fresh and untouched,
        "by design not in place: aggregate, aggregate_masked and apply_snapshots "
        "return new w_server / dw_tilde / alpha_applied because an eval snapshot "
        "(engine._Snapshot) holds w_server by reference; checked: new storage "
        f"{fresh}, inputs untouched {untouched} (in-place aggregation with a clone "
        "at eval snapshots is queued in ROADMAP's perf_opt)"))
    return out


def check_sweep_bucket_sharing(device=None, *, problem=None) -> list[ContractResult]:
    """Two grids in the same power-of-two buckets share one graph: a 3-cell
    grid with 3 eval boundaries and a 4-cell grid with 4 (R = 12 rounds,
    eval every 4 and every 3)."""
    dev = resolve_device(device)
    problem = toy_problem(dev) if problem is None else problem
    K = problem.X.shape[0]
    method = baselines.cocoa_plus(K, H=_H)
    cluster = ClusterModel(K)
    R = 12
    grids = {"a": (3, 4), "b": (4, 3)}  # (cells, eval_every): 3 and 4 evals

    def key(g):
        cells, every = grids[g]
        return sweep_lib.sweep_key(problem, method, cells, num_outer=R, eval_every=every,
                                   batch="vmap")

    def sweep(g):
        cells, every = grids[g]
        sweep_lib.run_sweep(problem, method, cluster, num_outer=R, seeds=range(cells),
                            eval_every=every, batch="vmap")

    same_key = key("a") == key("b")
    executor.clear_cache()
    t0 = executor.STATS["sweep_traces"]
    sweep("a")
    t1 = executor.STATS["sweep_traces"]
    held = executor.holds(key("b"))
    sweep("b")
    t2 = executor.STATS["sweep_traces"]
    ok = same_key and held and (t1 - t0, t2 - t1) == (1, 0)
    return [ContractResult(
        "sweep-bucket-cache-sharing", ok,
        f"3-cell/3-eval and 4-cell/4-eval grids have equal sweep keys: {same_key}; "
        f"after the first grid the executor holds the second's graph: {held}; "
        f"captures {[t1 - t0, t2 - t1]} (want [1, 0]: one shared graph)")]


def run_contracts(*, device=None, include_lag: bool = True) -> list[ContractResult]:
    """Run every contract check on ``device`` (the CUDA device unless
    ``"cpu"`` is given; raises without a card when none is named). A suite
    that raises becomes a failed result rather than a crash, so the CLI
    always reports per-contract."""
    dev = resolve_device(device)
    suites = [check_lockstep_contracts, check_engine_donation,
              check_sweep_bucket_sharing]
    if include_lag:
        suites.insert(1, check_lag_contracts)
    out: list[ContractResult] = []
    for suite in suites:
        try:
            out.extend(suite(dev))
        except Exception as e:  # an analyzer error is a failed contract
            out.append(ContractResult(suite.__name__, False,
                                      f"analyzer error: {e!r}"))
    return out
