"""Declarative, JSON-round-trippable experiment specs.

PyTorch counterpart of ``repro.api.spec``: the same fields, defaults,
validation and JSON, so a spec file written by ``repro`` loads here
unchanged and serializes back to the same text. An :class:`ExperimentSpec` is the serializable description of one complete
experiment: a problem registry entry, a :class:`ClusterModel`, a list of
methods (each a :class:`MethodConfig` plus its round budget), the eval/stop
policy and the seed. ``to_json``/``from_json`` round-trip losslessly
(``spec == ExperimentSpec.from_json(spec.to_json())``), so benchmarks,
examples, the ``python -m repro_torch`` CLI and future live-serving hooks all share
one entry point -- see :class:`repro_torch.api.session.Session` for execution.
"""

from __future__ import annotations

import dataclasses
import json
from typing import Any, Mapping

from repro_torch.api.problems import ProblemSpec
from repro_torch.core.acpd import MethodConfig
from repro_torch.core.simulate import ClusterModel


def _cluster_to_dict(c: ClusterModel) -> dict[str, Any]:
    d = dataclasses.asdict(c)
    d["straggler_workers"] = list(c.straggler_workers)
    # Normalized (name, value) pairs -> a plain JSON object; ClusterModel's
    # __post_init__ re-normalizes on the way back in.
    d["delay_params"] = dict(c.delay_params)
    # (worker, drop, rejoin) triples -> JSON [worker, drop, rejoin-or-null].
    d["membership"] = [list(e) for e in c.membership]
    return d


def _cluster_from_dict(d: Mapping[str, Any]) -> ClusterModel:
    kw = dict(d)
    if "straggler_workers" in kw:
        kw["straggler_workers"] = tuple(kw["straggler_workers"])
    if "membership" in kw:
        kw["membership"] = tuple(tuple(e) for e in kw["membership"])
    return ClusterModel(**kw)


def _method_from_dict(d: Mapping[str, Any]) -> MethodConfig:
    return MethodConfig(**dict(d))


@dataclasses.dataclass(frozen=True)
class MethodEntry:
    """One method inside a spec: the config plus its outer-round budget."""

    config: MethodConfig
    num_outer: int

    def to_dict(self) -> dict[str, Any]:
        return {"config": dataclasses.asdict(self.config),
                "num_outer": self.num_outer}

    @classmethod
    def from_dict(cls, d: Mapping[str, Any]) -> "MethodEntry":
        return cls(config=_method_from_dict(d["config"]),
                   num_outer=int(d["num_outer"]))


@dataclasses.dataclass(frozen=True)
class ExperimentSpec:
    """The single declarative description of an experiment run.

    ``target_gap`` / ``time_budget`` are the early-stop policy: a session
    streaming this spec stops once the duality gap reaches ``target_gap``
    (evaluated every ``eval_every`` rounds) or the simulated clock passes
    ``time_budget`` seconds, whichever comes first.

    ``executor`` picks the execution backend per method run: ``"auto"``
    (default) runs whole runs as one captured CUDA graph when the protocol
    and stop policy allow it and falls back to the event queue otherwise;
    ``"event"`` / ``"scan"`` force a backend.
    Both backends produce bit-identical results, so the field is a pure
    speed axis and old spec JSONs (without it) keep their meaning.

    ``shard`` picks how batched sweep executions
    (:func:`repro_torch.api.sweep.run_sweep` /
    :func:`repro_torch.api.sweep.sweep_spec`) partition work over the local
    devices (:func:`repro_torch.api.sweep.resolve_shard`); on one card every
    mode resolves to the unsharded path. Like ``executor``, a pure speed
    axis: old spec JSONs keep their meaning, and single-``Session`` runs
    ignore it.
    """

    name: str
    problem: ProblemSpec
    cluster: ClusterModel
    methods: tuple[MethodEntry, ...]
    eval_every: int = 1
    seed: int = 0
    target_gap: float | None = None
    time_budget: float | None = None
    executor: str = "auto"
    shard: str = "auto"
    # Checkpoint cadence (rounds): with it set, sessions for this spec run
    # as resumable scan segments and snapshot the carry every N rounds
    # (``repro_torch.core.executor.run_lockstep_checkpointed``); the snapshot
    # location is execution state, not spec state, so it travels separately
    # (``Experiment(spec, checkpoint_dir=...)``).  ``None`` (the default -- old spec JSONs keep
    # their meaning) never checkpoints.
    checkpoint_every: int | None = None

    def __post_init__(self):
        object.__setattr__(self, "methods", tuple(self.methods))

    def method_named(self, name: str) -> MethodEntry:
        for entry in self.methods:
            if entry.config.name == name:
                return entry
        raise KeyError(f"no method named {name!r} in spec {self.name!r}")

    # -- validation --------------------------------------------------------

    def validate(self) -> "ExperimentSpec":
        """Resolve every registry name and structural invariant WITHOUT
        building the dataset or compiling anything; returns ``self``.

        Raises ``ValueError`` naming the bad entry AND the full list of
        known entries (problem kinds, protocols, compressors, delay models,
        local solvers) so a caller -- in particular a serve layer's
        admission gate, where a queued bad spec must never reach a batch --
        can reject at enqueue time with an actionable message.  ``Session``
        construction performs the same resolution; this front-loads it for
        specs that are queued before they run.
        """
        import inspect

        from repro_torch.api import problems as problems_lib
        from repro_torch.core import compress as compress_lib
        from repro_torch.core import delays as delays_lib
        from repro_torch.core import engine as engine_lib
        from repro_torch.core import solvers as solvers_lib

        errors: list[str] = []
        builder = problems_lib._PROBLEMS.get(self.problem.kind)
        if builder is None:
            errors.append(
                f"unknown problem {self.problem.kind!r}; available: "
                f"{problems_lib.available_problems()}")
        else:
            params = inspect.signature(builder).parameters
            unknown = sorted(set(self.problem.params) - set(params))
            if unknown:
                errors.append(
                    f"problem {self.problem.kind!r} got unknown params "
                    f"{unknown}; accepted: {sorted(params)}")
        try:
            delays_lib.get_delay(self.cluster.delay_model)
        except ValueError as e:
            errors.append(str(e))
        if not self.methods:
            errors.append("spec declares no methods")
        names = [m.config.name for m in self.methods]
        if len(set(names)) != len(names):
            errors.append(f"duplicate method names in spec: {names}")
        for entry in self.methods:
            cfg = entry.config
            where = f"method {cfg.name!r}"
            if cfg.protocol not in engine_lib.available_protocols():
                errors.append(
                    f"{where}: unknown protocol {cfg.protocol!r}; "
                    f"available: {engine_lib.available_protocols()}")
            if cfg.compressor is not None:
                try:
                    compress_lib.get_compressor(cfg.compressor)
                except ValueError as e:
                    errors.append(f"{where}: {e}")
            try:
                solvers_lib.get_solver(cfg.local_solver)
            except ValueError as e:
                errors.append(f"{where}: {e}")
            if entry.num_outer <= 0:
                errors.append(f"{where}: num_outer must be >= 1, got "
                              f"{entry.num_outer}")
            if not 1 <= cfg.B <= self.cluster.num_workers:
                errors.append(
                    f"{where}: B={cfg.B} outside [1, K={self.cluster.num_workers}]")
            if cfg.n_chunks < 1:
                errors.append(f"{where}: n_chunks must be >= 1, got "
                              f"{cfg.n_chunks}")
            elif cfg.n_chunks > cfg.H:
                errors.append(
                    f"{where}: n_chunks={cfg.n_chunks} exceeds H={cfg.H}: "
                    f"every chunk needs at least one local step")
            if cfg.pw_quantum is not None and cfg.pw_quantum <= 0:
                errors.append(f"{where}: pw_quantum must be > 0, got "
                              f"{cfg.pw_quantum}")
            K = self.cluster.num_workers
            if cfg.protocol == "hierarchical_b":
                if not 1 <= cfg.n_racks <= K:
                    errors.append(f"{where}: n_racks={cfg.n_racks} outside "
                                  f"[1, K={K}]")
                else:
                    sizes = [sum(1 for k in range(K)
                                 if k * cfg.n_racks // K == r)
                             for r in range(cfg.n_racks)]
                    if not 1 <= cfg.rack_b <= min(sizes):
                        errors.append(
                            f"{where}: rack_b={cfg.rack_b} outside "
                            f"[1, min rack size={min(sizes)}] (racks of "
                            f"{sizes})")
            if self.cluster.membership:
                try:
                    proto_cls = engine_lib.get_protocol(cfg.protocol)
                except ValueError:
                    proto_cls = None  # unknown protocol: reported above
                if proto_cls is not None and not getattr(
                        proto_cls, "supports_membership", False):
                    errors.append(
                        f"{where}: protocol {cfg.protocol!r} does not "
                        f"support the cluster's elastic membership schedule "
                        f"(supporting protocols declare supports_membership)")
        for entry in self.cluster.membership:
            k, drop, rejoin = entry
            if not 0 <= k < self.cluster.num_workers:
                errors.append(
                    f"membership entry {list(entry)}: worker {k} outside "
                    f"[0, K={self.cluster.num_workers})")
            if drop < 0:
                errors.append(f"membership entry {list(entry)}: drop time "
                              f"must be >= 0")
            if rejoin is not None and rejoin <= drop:
                errors.append(
                    f"membership entry {list(entry)}: rejoin time must be "
                    f"> drop time (use null for never-rejoins)")
        if self.eval_every <= 0:
            errors.append(f"eval_every must be >= 1, got {self.eval_every}")
        if self.checkpoint_every is not None:
            from repro_torch.core import executor as executor_lib

            if self.checkpoint_every < 1:
                errors.append(f"checkpoint_every must be >= 1, got "
                              f"{self.checkpoint_every}")
            for entry in self.methods:
                ok, why = executor_lib.checkpoint_supported(
                    entry.config, self.cluster, target_gap=self.target_gap,
                    time_budget=self.time_budget)
                if not ok:
                    errors.append(
                        f"method {entry.config.name!r}: {why}")
        if self.executor not in ("auto", "event", "scan"):
            errors.append(f"unknown executor {self.executor!r}; expected "
                          f"'auto', 'event' or 'scan'")
        from repro_torch.api.sweep import SHARD_MODES
        if self.shard not in SHARD_MODES:
            errors.append(f"unknown shard mode {self.shard!r}; expected one "
                          f"of {SHARD_MODES}")
        if errors:
            raise ValueError(
                f"invalid spec {self.name!r}: " + "; ".join(errors))
        return self

    # -- serialization -----------------------------------------------------

    def to_dict(self) -> dict[str, Any]:
        return {
            "name": self.name,
            "problem": self.problem.to_dict(),
            "cluster": _cluster_to_dict(self.cluster),
            "methods": [m.to_dict() for m in self.methods],
            "eval_every": self.eval_every,
            "seed": self.seed,
            "target_gap": self.target_gap,
            "time_budget": self.time_budget,
            "executor": self.executor,
            "shard": self.shard,
            "checkpoint_every": self.checkpoint_every,
        }

    @classmethod
    def from_dict(cls, d: Mapping[str, Any]) -> "ExperimentSpec":
        return cls(
            name=d["name"],
            problem=ProblemSpec.from_dict(d["problem"]),
            cluster=_cluster_from_dict(d["cluster"]),
            methods=tuple(MethodEntry.from_dict(m) for m in d["methods"]),
            eval_every=int(d.get("eval_every", 1)),
            seed=int(d.get("seed", 0)),
            target_gap=d.get("target_gap"),
            time_budget=d.get("time_budget"),
            executor=d.get("executor", "auto"),
            shard=d.get("shard", "auto"),
            checkpoint_every=d.get("checkpoint_every"),
        )

    def to_json(self, indent: int = 2) -> str:
        return json.dumps(self.to_dict(), indent=indent)

    @classmethod
    def from_json(cls, text: str) -> "ExperimentSpec":
        return cls.from_dict(json.loads(text))

    @classmethod
    def load(cls, path) -> "ExperimentSpec":
        with open(path) as f:
            return cls.from_dict(json.load(f))

    def save(self, path) -> None:
        with open(path, "w") as f:
            f.write(self.to_json() + "\n")
