"""Problem registry: named, JSON-parameterizable dataset builders.

PyTorch counterpart of ``repro.api.problems``: the same entry names and
defaults, plus the ``device`` the problem's tensors live on.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Mapping

import torch

from repro_torch.core.objectives import Problem
from repro_torch.data.synthetic import LinearDatasetSpec, make_linear_problem

_PROBLEMS: dict[str, Callable[..., Problem]] = {}


def register_problem(name: str):
    """Decorator: register a keyword-only problem builder under ``name``."""

    def deco(fn: Callable[..., Problem]) -> Callable[..., Problem]:
        _PROBLEMS[name] = fn
        return fn

    return deco


def available_problems() -> tuple[str, ...]:
    return tuple(sorted(_PROBLEMS))


@dataclasses.dataclass(frozen=True)
class ProblemSpec:
    """A registry entry name + its keyword parameters (JSON-round-trippable)."""

    kind: str
    params: Mapping[str, Any] = dataclasses.field(default_factory=dict)

    def build(self, *, device: str | torch.device | None = None) -> Problem:
        try:
            fn = _PROBLEMS[self.kind]
        except KeyError:
            raise ValueError(
                f"unknown problem {self.kind!r}; available: "
                f"{available_problems()}") from None
        return fn(**self.params, device=device)

    def to_dict(self) -> dict[str, Any]:
        return {"kind": self.kind, "params": dict(self.params)}

    @classmethod
    def from_dict(cls, d: Mapping[str, Any]) -> "ProblemSpec":
        return cls(kind=d["kind"], params=dict(d.get("params", {})))


def build_problem(spec: ProblemSpec, *,
                  device: str | torch.device | None = None) -> Problem:
    return spec.build(device=device)


@register_problem("linear_synthetic")
def linear_synthetic(*, num_workers: int = 4, n_per_worker: int = 512,
                     d: int = 8192, nnz_per_row: int = 64,
                     label_noise: float = 0.05, task: str = "classification",
                     seed: int = 0, lam: float = 1e-4, loss: str = "ridge",
                     device: str | torch.device | None = None) -> Problem:
    """The generic K-partitioned sparse linear problem (Assumption 1 data)."""
    spec = LinearDatasetSpec(num_workers=num_workers, n_per_worker=n_per_worker,
                             d=d, nnz_per_row=nnz_per_row,
                             label_noise=label_noise, task=task, seed=seed)
    return make_linear_problem(spec, lam=lam, loss=loss, device=device)


@register_problem("rcv1_like")
def rcv1_like(*, K: int = 4, seed: int = 7, d: int = 2048,
              n_per_worker: int = 192, nnz_per_row: int = 24,
              lam: float = 1e-3, loss: str = "ridge",
              device: str | torch.device | None = None) -> Problem:
    """Scaled-down stand-in for the paper's RCV1 split (benchmark default)."""
    return linear_synthetic(num_workers=K, n_per_worker=n_per_worker, d=d,
                            nnz_per_row=nnz_per_row, seed=seed, lam=lam,
                            loss=loss, device=device)
