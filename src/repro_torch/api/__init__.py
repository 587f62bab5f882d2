"""The public API surface of the port: declarative specs + streaming sessions.

The exports of ``repro.api``, on PyTorch:

* :class:`ExperimentSpec` / :class:`MethodEntry` / :class:`ProblemSpec` --
  declarative, JSON-round-trippable experiment descriptions (a spec file
  written by ``repro`` loads here unchanged);
* :class:`Session` / :class:`Experiment` and the typed event stream
  (:class:`RoundEvent`, :class:`EvalEvent`, :class:`SyncEvent`,
  :class:`StopEvent`) -- streaming execution with early stop, on either
  backend (``executor="auto"|"event"|"scan"``; the whole-run executor is one
  captured CUDA graph per run on the card, equal to the event loop bit for
  bit);
* :func:`run_sweep` / :func:`sweep_spec` / :func:`run_sweep_cells` -- whole
  delay x seed x gamma grids of a lockstep or ``lag`` method in one
  captured graph (:func:`run_lockstep_sweep` is the lockstep-only
  wrapper);
* the compressor, delay-model and local-solver registries (re-exported);
* preset spec builders for the paper's figures plus the straggler-zoo
  family (:mod:`repro_torch.api.presets`).

CLI: ``python -m repro_torch run spec.json`` / ``python -m repro_torch spec
<preset>``.
"""

from repro_torch.api.presets import PRESETS, build_preset  # noqa: F401
from repro_torch.api.problems import (  # noqa: F401
    ProblemSpec,
    available_problems,
    build_problem,
    register_problem,
)
from repro_torch.api.session import (  # noqa: F401
    EvalEvent,
    Experiment,
    RoundEvent,
    Session,
    SessionEvent,
    StopEvent,
    SyncEvent,
)
from repro_torch.api.spec import ExperimentSpec, MethodEntry  # noqa: F401
from repro_torch.api.sweep import (  # noqa: F401
    ShardPlan,
    SweepCellSpec,
    SweepVariant,
    resolve_shard,
    run_lockstep_sweep,
    run_sweep,
    run_sweep_cells,
    sweep_spec,
    sweep_supported,
)
from repro_torch.core.compress import (  # noqa: F401
    Compressor,
    available_compressors,
    get_compressor,
    register_compressor,
)
from repro_torch.core.delays import (  # noqa: F401
    DelayModel,
    available_delays,
    get_delay,
    register_delay,
)
from repro_torch.core.solvers import (  # noqa: F401
    available_solvers,
    get_solver,
    register_solver,
)

__all__ = [
    "Compressor",
    "DelayModel",
    "EvalEvent",
    "Experiment",
    "ExperimentSpec",
    "MethodEntry",
    "PRESETS",
    "ProblemSpec",
    "RoundEvent",
    "Session",
    "SessionEvent",
    "ShardPlan",
    "StopEvent",
    "SweepCellSpec",
    "SweepVariant",
    "SyncEvent",
    "available_compressors",
    "available_delays",
    "available_problems",
    "available_solvers",
    "build_preset",
    "build_problem",
    "get_compressor",
    "get_delay",
    "get_solver",
    "register_compressor",
    "register_delay",
    "register_solver",
    "resolve_shard",
    "run_lockstep_sweep",
    "run_sweep",
    "run_sweep_cells",
    "sweep_spec",
    "sweep_supported",
]
