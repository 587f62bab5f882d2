"""Named ExperimentSpec builders: the paper's figures/tables as specs.

PyTorch counterpart of ``repro.api.presets``: the same builders, names and
specs, so ``python -m repro_torch spec <preset>`` prints the text that
``python -m repro spec <preset>`` prints. A figure run is fully described
by one JSON document (``spec.to_json()``).

``quick=True`` is the smoke scale of the benchmarks' ``--quick`` runs.
"""

from __future__ import annotations

import dataclasses

from repro_torch.api.problems import ProblemSpec
from repro_torch.api.spec import ExperimentSpec, MethodEntry
from repro_torch.core import baselines
from repro_torch.core.simulate import ClusterModel


def rcv1_spec(K: int = 4, seed: int = 7, d: int = 2048,
              n_per_worker: int = 192) -> ProblemSpec:
    """The benchmarks' RCV1-like problem as a registry reference."""
    return ProblemSpec("rcv1_like", {"K": K, "seed": seed, "d": d,
                                     "n_per_worker": n_per_worker})


def cluster_model(K: int, sigma: float = 1.0, jitter: float = 0.0,
                  delay: str = "constant",
                  delay_params: dict | None = None) -> ClusterModel:
    return ClusterModel(num_workers=K, straggler_sigma=sigma, jitter=jitter,
                        delay_model=delay,
                        delay_params=tuple((delay_params or {}).items()))


def fig3(sigma: float = 10.0, quick: bool = False,
         target_gap: float | None = None) -> ExperimentSpec:
    """Fig. 3 convergence: CoCoA+ vs ACPD vs the B=K / rho=1 ablations."""
    K = 4
    d = 512 if quick else 2048
    H = 64 if quick else 256
    methods = (
        MethodEntry(baselines.cocoa_plus(K, H=H), 10 if quick else 60),
        MethodEntry(baselines.acpd(K, d, B=2, T=10, rho_d=64, gamma=0.5, H=H),
                    3 if quick else 12),
        MethodEntry(baselines.acpd_full_barrier(K, d, T=10, rho_d=64,
                                                gamma=0.5, H=H),
                    2 if quick else 8),
        MethodEntry(baselines.acpd_dense(K, B=2, T=10, gamma=0.5, H=H),
                    2 if quick else 8),
    )
    return ExperimentSpec(
        name=f"fig3-convergence-sigma{int(sigma)}{'-quick' if quick else ''}",
        problem=rcv1_spec(K=K, d=d), cluster=cluster_model(K, sigma=sigma),
        methods=methods, eval_every=2, seed=0, target_gap=target_gap)


def fig4a(quick: bool = False) -> ExperimentSpec:
    """Fig. 4a: the sparsity constant rho swept as one spec (one ACPD entry
    per rho*d, distinguished by method name)."""
    K = 4
    d = 512 if quick else 2048
    H = 64 if quick else 256
    outer = 2 if quick else 8
    methods = []
    for rho_d in ((8, 128) if quick else (8, 32, 128, 512, 2048)):
        m = baselines.acpd(K, d, B=2, T=10, rho_d=rho_d, gamma=0.5, H=H)
        methods.append(MethodEntry(
            dataclasses.replace(m, name=f"ACPD-rho_d{rho_d}"), outer))
    return ExperimentSpec(
        name=f"fig4a-rho{'-quick' if quick else ''}",
        problem=rcv1_spec(K=K, d=d), cluster=cluster_model(K),
        methods=tuple(methods), eval_every=2, seed=0)


def fig4b(K: int, quick: bool = False) -> ExperimentSpec:
    """Fig. 4b worker scaling at one K: all four registry protocols."""
    d = 1024 if quick else 8192
    H = 64 if quick else 256
    methods = (
        MethodEntry(baselines.acpd(K, d, B=max(1, K // 2), T=10, rho_d=128,
                                   gamma=0.5, H=H), 2 if quick else 8),
        MethodEntry(baselines.cocoa_plus(K, H=H), 10 if quick else 60),
        MethodEntry(baselines.acpd_async(K, d, T=10, rho_d=128, gamma=0.5,
                                         H=H), 4 if quick else 16),
        MethodEntry(baselines.acpd_lag(K, d, B=max(1, K // 2), T=10,
                                       rho_d=128, gamma=0.5, H=H),
                    2 if quick else 8),
    )
    return ExperimentSpec(
        name=f"fig4b-scaling-K{K}{'-quick' if quick else ''}",
        problem=rcv1_spec(K=K, d=d, n_per_worker=64 if quick else 128,
                          seed=7 + K),
        cluster=cluster_model(K, sigma=1.0), methods=methods, eval_every=2,
        seed=0)


def fig5(quick: bool = False) -> ExperimentSpec:
    """Fig. 5 'real environment' proxy: lognormal jitter on every worker."""
    K, d = (4, 1024) if quick else (8, 4096)
    H = 64 if quick else 256
    methods = (
        MethodEntry(baselines.acpd(K, d, B=K // 2, T=10, rho_d=64, gamma=0.5,
                                   H=H), 2 if quick else 8),
        MethodEntry(baselines.cocoa_plus(K, H=H), 10 if quick else 60),
    )
    return ExperimentSpec(
        name=f"fig5-realenv{'-quick' if quick else ''}",
        problem=rcv1_spec(K=K, d=d, n_per_worker=96, seed=31),
        cluster=cluster_model(K, sigma=1.0, jitter=0.6), methods=methods,
        eval_every=2, seed=0)


def table1(quick: bool = False) -> ExperimentSpec:
    """Table I bytes-per-round accounting runs."""
    K = 4
    d = 512 if quick else 2048
    H = 64 if quick else 256
    methods = (
        MethodEntry(baselines.cocoa_plus(K, H=H), 5 if quick else 20),
        MethodEntry(baselines.acpd(K, d, rho_d=64, H=H), 1 if quick else 2),
        MethodEntry(baselines.acpd_dense(K, H=H), 1 if quick else 2),
    )
    return ExperimentSpec(
        name=f"table1-bytes{'-quick' if quick else ''}",
        problem=rcv1_spec(K=K, d=d), cluster=cluster_model(K),
        methods=methods, eval_every=5, seed=0)


def quickstart(quick: bool = False,
               target_gap: float | None = 1e-3) -> ExperimentSpec:
    """The examples/quickstart.py comparison as a spec (with early stop)."""
    K = 4
    d = 1024 if quick else 4096
    H = 128 if quick else 512
    methods = (
        MethodEntry(baselines.cocoa_plus(K, H=H), 10 if quick else 40),
        MethodEntry(baselines.acpd(K, d, B=2, T=10, rho_d=128, gamma=0.5,
                                   H=H), 3 if quick else 8),
    )
    return ExperimentSpec(
        name=f"quickstart{'-quick' if quick else ''}",
        problem=ProblemSpec("linear_synthetic",
                            {"num_workers": K, "n_per_worker": 256, "d": d,
                             "nnz_per_row": 32, "seed": 0, "lam": 1e-3,
                             "loss": "ridge"}),
        cluster=ClusterModel(num_workers=K, straggler_sigma=5.0),
        methods=methods, eval_every=4, seed=0, target_gap=target_gap)


# -- the straggler-zoo preset family ----------------------------------------
#
# One spec per delay model, each running the full protocol zoo against it:
# the "straggler-agnostic" claim as a stress grid instead of a single
# hard-coded delay shape.

ZOO_DELAYS: dict[str, dict] = {
    "constant": {},
    "shifted_exponential": {"tail_mean": 1.0},
    "pareto": {"shape": 1.8, "scale": 0.5},
    "markov": {"p_slow": 0.1, "p_recover": 0.25, "slow_factor": 8.0},
    "bandwidth_coupled": {"link_slowdown": 20.0},
}


def straggler_zoo(delay: str = "pareto", quick: bool = False,
                  target_gap: float | None = None) -> ExperimentSpec:
    """Protocol zoo vs one delay model: every server discipline in the
    registry against the named straggler behavior.

    ``bandwidth_coupled`` zeroes the compute slowdown (the straggler is a
    slow LINK, so the payload-byte coupling with the compressor is the only
    handicap); every other model keeps the paper's sigma=5 compute straggler.
    """
    if delay not in ZOO_DELAYS:
        raise ValueError(
            f"unknown zoo delay {delay!r}; available: {tuple(sorted(ZOO_DELAYS))}")
    K = 4
    d = 512 if quick else 2048
    H = 64 if quick else 256
    sigma = 1.0 if delay == "bandwidth_coupled" else 5.0
    methods = (
        MethodEntry(baselines.cocoa_plus(K, H=H), 10 if quick else 60),
        MethodEntry(baselines.acpd(K, d, B=2, T=10, rho_d=64, gamma=0.5, H=H),
                    3 if quick else 12),
        MethodEntry(baselines.acpd_adaptive(K, d, T=10, rho_d=64, gamma=0.5,
                                            H=H, quantile=0.5),
                    3 if quick else 12),
        MethodEntry(baselines.acpd_lag(K, d, B=2, T=10, rho_d=64, gamma=0.5,
                                       H=H), 3 if quick else 12),
        # Equal byte budget with the acpd() row by construction: n_chunks
        # chunks of rho_d/n_chunks coordinates each per full pass.
        MethodEntry(baselines.acpd_partial_work(K, d, B=2, T=10, rho_d=64,
                                                gamma=0.5, H=H, n_chunks=4),
                    3 if quick else 12),
        MethodEntry(baselines.acpd_hierarchical(K, d, T=10, rho_d=64,
                                                gamma=0.5, H=H, n_racks=2,
                                                rack_b=1),
                    3 if quick else 12),
        MethodEntry(baselines.acpd_async(K, d, T=10, rho_d=64, gamma=0.5,
                                         H=H), 10 if quick else 40),
        MethodEntry(baselines.cocoa_v1(K, H=H), 10 if quick else 60),
        MethodEntry(baselines.cocoa_plus_solver(K, H=H,
                                                local_solver="accelerated"),
                    10 if quick else 60),
    )
    return ExperimentSpec(
        name=f"zoo-{delay}{'-quick' if quick else ''}",
        problem=rcv1_spec(K=K, d=d),
        cluster=cluster_model(K, sigma=sigma, delay=delay,
                              delay_params=ZOO_DELAYS[delay]),
        methods=methods, eval_every=2, seed=0, target_gap=target_gap)


PRESETS = {
    "fig3": fig3,
    "fig4a": fig4a,
    "fig5": fig5,
    "table1": table1,
    "quickstart": quickstart,
}
# fig4b takes a required K; expose the paper's K values as named presets.
for _K in (2, 4, 8):
    PRESETS[f"fig4b-K{_K}"] = (lambda K: lambda quick=False: fig4b(K, quick))(_K)
# The straggler-zoo family: one preset per registered zoo delay model.
for _delay in sorted(ZOO_DELAYS):
    PRESETS[f"zoo-{_delay}"] = (
        lambda dl: lambda quick=False, target_gap=None: straggler_zoo(
            dl, quick=quick, target_gap=target_gap))(_delay)


def build_preset(name: str, **kwargs) -> ExperimentSpec:
    try:
        fn = PRESETS[name]
    except KeyError:
        raise ValueError(
            f"unknown preset {name!r}; available: {tuple(sorted(PRESETS))}"
        ) from None
    return fn(**kwargs)
