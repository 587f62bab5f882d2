"""Named method presets: the paper's baselines and ablations (Table I, Fig. 3).

A copy of ``repro.core.baselines``. Every preset runs through
``repro_torch.core.acpd.run_method`` (the protocol engine); the ``group`` and
``sync`` presets also run on the reference loops.

* CoCoA+  (Ma et al. 2015): synchronous, "adding" aggregation -> gamma=1, sigma'=K.
* CoCoA   (Jaggi et al. 2014): synchronous, "averaging" -> gamma=1/K, sigma'=1.
* DisDCA  (Yang 2013, practical variant): equivalent to CoCoA+ under the
  conditions shown in Ma et al. 2015 Sec. 4; kept as its own named config.
* ACPD              : group-wise (B of K) + top-rho*d filter (the paper).
* ACPD-B=K ablation : group-wise machinery but full barrier (isolates sparsity).
* ACPD-rho=1 ablation: group-wise, dense messages (isolates straggler-agnosticism).
"""

from __future__ import annotations

from repro_torch.core.acpd import MethodConfig


def cocoa_plus(K: int, H: int = 1000) -> MethodConfig:
    return MethodConfig(name="CoCoA+", protocol="sync", B=K, rho=1.0, gamma=1.0,
                        sigma_prime=float(K), H=H)


def cocoa(K: int, H: int = 1000) -> MethodConfig:
    return MethodConfig(name="CoCoA", protocol="sync", B=K, rho=1.0, gamma=1.0 / K,
                        sigma_prime=1.0, H=H)


def disdca(K: int, H: int = 1000) -> MethodConfig:
    return MethodConfig(name="DisDCA", protocol="sync", B=K, rho=1.0, gamma=1.0,
                        sigma_prime=float(K), H=H)


def acpd(K: int, d: int, *, B: int | None = None, T: int = 20, rho_d: int = 1000,
         gamma: float = 0.5, H: int = 1000) -> MethodConfig:
    B = B if B is not None else max(1, K // 2)
    return MethodConfig(name="ACPD", protocol="group", B=B, T=T,
                        rho=min(1.0, rho_d / d), gamma=gamma, H=H)


def acpd_full_barrier(K: int, d: int, *, T: int = 20, rho_d: int = 1000,
                      gamma: float = 0.5, H: int = 1000) -> MethodConfig:
    """Ablation B=K: keeps sparsity, removes straggler-agnosticism."""
    return MethodConfig(name="ACPD-B=K", protocol="group", B=K, T=T,
                        rho=min(1.0, rho_d / d), gamma=gamma, H=H)


def acpd_dense(K: int, *, B: int | None = None, T: int = 20, gamma: float = 0.5,
               H: int = 1000) -> MethodConfig:
    """Ablation rho=1: keeps group-wise protocol, removes sparsity."""
    B = B if B is not None else max(1, K // 2)
    return MethodConfig(name="ACPD-rho=1", protocol="group", B=B, T=T,
                        rho=1.0, gamma=gamma, H=H)


def acpd_async(K: int, d: int, *, T: int = 20, rho_d: int = 1000,
               gamma: float = 0.5, H: int = 1000) -> MethodConfig:
    """Fully-asynchronous: B=1, per-arrival apply, no sync barrier.

    ``T`` only sets the round budget (num_outer * T rounds), not a barrier.
    sigma' is floored at 1: the paper's gamma*B rule would give gamma < 1,
    under-damping the local subproblem when every round applies one worker.
    """
    return MethodConfig(name="ACPD-async", protocol="async", B=1, T=T,
                        rho=min(1.0, rho_d / d), gamma=gamma, H=H,
                        sigma_prime=max(1.0, gamma))


def acpd_lag(K: int, d: int, *, B: int | None = None, T: int = 20,
             rho_d: int = 1000, gamma: float = 0.5, H: int = 1000,
             lag_xi: float = 1.0, lag_window: int = 10) -> MethodConfig:
    """LAG-style lazy uploads on top of the group protocol (engine.LagProtocol)."""
    B = B if B is not None else max(1, K // 2)
    return MethodConfig(name="ACPD-LAG", protocol="lag", B=B, T=T,
                        rho=min(1.0, rho_d / d), gamma=gamma, H=H,
                        lag_xi=lag_xi, lag_window=lag_window)


def cocoa_v1(K: int, H: int = 1000, local_solver: str = "sdca") -> MethodConfig:
    """CoCoA with averaging aggregation (gamma=1/K, sigma'=1) on the
    pluggable-solver ``cocoa`` protocol (engine.CocoaProtocol)."""
    return MethodConfig(name=f"CoCoA[{local_solver}]", protocol="cocoa",
                        B=K, rho=1.0, gamma=1.0 / K, H=H,
                        local_solver=local_solver)


def cocoa_plus_solver(K: int, H: int = 1000, gamma: float = 1.0,
                      local_solver: str = "sdca") -> MethodConfig:
    """CoCoA+ adding aggregation (sigma'=gamma*K) with a registry-chosen
    local solver (engine.CocoaPlusProtocol)."""
    return MethodConfig(name=f"CoCoA+[{local_solver}]", protocol="cocoa_plus",
                        B=K, rho=1.0, gamma=gamma, H=H,
                        local_solver=local_solver)


def acpd_partial_work(K: int, d: int, *, B: int | None = None, T: int = 20,
                      rho_d: int = 1000, gamma: float = 0.5, H: int = 1000,
                      n_chunks: int = 4,
                      pw_quantum: float | None = None) -> MethodConfig:
    """Straggler-UTILIZING chunk streaming (engine.PartialWorkProtocol):
    each local pass splits into ``n_chunks`` streamed partial updates, and
    the server harvests whatever chunks arrived by its B-th-full-arrival
    deadline (or every ``pw_quantum`` simulated seconds when set).

    Equal-byte-budget by construction: the per-chunk sparsity is
    ``rho_d / n_chunks`` coordinates, so one FULL pass ships exactly the
    bytes of one ``acpd()`` round -- comparisons against ``group`` isolate
    the harvest-partial-work effect from the communication budget.
    """
    B = B if B is not None else max(1, K // 2)
    return MethodConfig(name="ACPD-partial", protocol="partial_work", B=B,
                        T=T, rho=min(1.0, rho_d / (max(1, n_chunks) * d)),
                        gamma=gamma, H=H, n_chunks=n_chunks,
                        pw_quantum=pw_quantum)


def acpd_hierarchical(K: int, d: int, *, T: int = 20, rho_d: int = 1000,
                      gamma: float = 0.5, H: int = 1000, n_racks: int = 2,
                      rack_b: int = 1) -> MethodConfig:
    """Two-level rack-aware aggregation (engine.HierarchicalBProtocol):
    per-rack ``rack_b``-of-k deadlines, then one cross-rack merge.  ``B`` is
    ignored by the arrival rule (the per-rack quotas replace it) but kept at
    the group default so sigma'-resolution and spec validation see a
    consistent config."""
    return MethodConfig(name="ACPD-hier", protocol="hierarchical_b",
                        B=max(1, K // 2), T=T, rho=min(1.0, rho_d / d),
                        gamma=gamma, H=H, n_racks=n_racks, rack_b=rack_b)


def acpd_adaptive(K: int, d: int, *, T: int = 20, rho_d: int = 1000,
                  gamma: float = 0.5, H: int = 1000, quantile: float = 0.5,
                  b_min: int = 1) -> MethodConfig:
    """Adaptive group sizing: B learned from observed arrival latencies
    (engine.AdaptiveBProtocol); B seeds the pre-observation rounds only."""
    return MethodConfig(name="ACPD-adaptiveB", protocol="adaptive_b",
                        B=max(1, K // 2), T=T, rho=min(1.0, rho_d / d),
                        gamma=gamma, H=H, adaptive_quantile=quantile,
                        b_min=b_min)


ALL_PRESETS = {
    "cocoa": cocoa,
    "cocoa_plus": cocoa_plus,
    "disdca": disdca,
    "acpd": acpd,
    "acpd_full_barrier": acpd_full_barrier,
    "acpd_dense": acpd_dense,
    "acpd_async": acpd_async,
    "acpd_lag": acpd_lag,
    "acpd_partial_work": acpd_partial_work,
    "acpd_hierarchical": acpd_hierarchical,
    "cocoa_v1": cocoa_v1,
    "cocoa_plus_solver": cocoa_plus_solver,
    "acpd_adaptive": acpd_adaptive,
}
