"""Carry state across from the JAX package.

The JAX package's arrays (numpy views of its ``jax.Array`` results) become
the port's tensors here, so that both packages can compute on the same data:
a problem built by ``repro``, a loop state (the server model, the duals,
the workers' residuals and the server's catch-up buffers) taken from a run,
a model's parameter tree, or a training run's optimizer and exchange state.
Values are copied bit for bit; nothing is recomputed.
"""

from __future__ import annotations

from typing import Mapping

import numpy as np
import torch

from repro_torch.core.exchange import ExchangeState
from repro_torch.core.objectives import Problem
from repro_torch.device import resolve_device
from repro_torch.models.config import ModelConfig
from repro_torch.models.model import model_spec
from repro_torch.models.param import tree_leaves_with_path
from repro_torch.optim.optimizers import OptState

# The state of the group loop (Algorithms 1 + 2), by the reference loop's
# names: the server model and catch-up buffers, the workers' models, duals
# and residuals.
STATE_FIELDS = ("w_server", "dw_tilde", "w_local", "alpha", "alpha_applied",
                "residual")


def _tensor(a, dtype: torch.dtype, device: torch.device) -> torch.Tensor:
    arr = np.array(a, order="C")  # a writable host copy
    return torch.from_numpy(arr).to(device=device, dtype=dtype)


def problem_from_arrays(X, y, lam: float, loss: str = "ridge", *,
                        device: str | torch.device | None = None) -> Problem:
    """A port :class:`Problem` holding copies of ``X (K, n_k, d)``, ``y (K, n_k)``."""
    dev = resolve_device(device)
    X_t, y_t = _tensor(X, torch.float32, dev), _tensor(y, torch.float32, dev)
    if X_t.dim() != 3 or y_t.shape != X_t.shape[:2]:
        raise ValueError(
            f"need X (K, n_k, d) and y (K, n_k), got {tuple(X_t.shape)} and "
            f"{tuple(y_t.shape)}")
    return Problem(X=X_t, y=y_t, lam=float(lam), loss=loss)  # type: ignore[arg-type]


def problem_to_arrays(problem: Problem) -> tuple[np.ndarray, np.ndarray]:
    """``(X, y)`` as host numpy arrays, for handing back to the JAX package."""
    return problem.X.cpu().numpy(), problem.y.cpu().numpy()


def state_from_arrays(arrays: Mapping[str, object], *,
                      device: str | torch.device | None = None
                      ) -> dict[str, torch.Tensor]:
    """float32 tensors on ``device`` from named loop-state arrays.

    Keys must be among :data:`STATE_FIELDS`; any subset may be given.
    """
    dev = resolve_device(device)
    unknown = sorted(set(arrays) - set(STATE_FIELDS))
    if unknown:
        raise ValueError(f"unknown state fields {unknown}; known: {STATE_FIELDS}")
    return {name: _tensor(a, torch.float32, dev) for name, a in arrays.items()}


def state_to_arrays(state: Mapping[str, torch.Tensor]) -> dict[str, np.ndarray]:
    """The inverse of :func:`state_from_arrays`: host numpy copies."""
    return {name: t.detach().cpu().numpy() for name, t in state.items()}


def _leaf_tensor(a) -> torch.Tensor:
    """A host tensor holding ``a``'s bits; bfloat16 goes through int16.

    ``np.asarray`` of a JAX bfloat16 array has ``ml_dtypes``' bfloat16 dtype,
    which ``torch.from_numpy`` refuses.
    """
    arr = np.array(a, order="C")  # a writable host copy
    if arr.dtype.name == "bfloat16":
        return torch.from_numpy(arr.view(np.int16)).view(torch.bfloat16)
    return torch.from_numpy(arr)


def params_from_arrays(tree: Mapping, cfg: ModelConfig, *,
                       device: str | torch.device | None = None) -> dict:
    """The port's parameter tree from the JAX package's, leaf for leaf.

    ``tree`` is the JAX tree for ``cfg`` (nested dicts of ``jax.Array`` or
    numpy arrays, the same names). Every path of ``model_spec(cfg)`` must be
    present with its shape and dtype, and no other; values are copied bit
    for bit.
    """
    want = {path: (s.shape, s.dtype)
            for path, s in tree_leaves_with_path(model_spec(cfg))}
    return _tree_from_arrays(tree, want, "parameter tree", resolve_device(device))


def _tree_from_arrays(tree: Mapping, want: dict, what: str, dev: torch.device) -> dict:
    """Nested dicts of tensors on ``dev`` from ``tree``, whose dotted paths
    must be exactly ``want``'s, each leaf of ``want[path]``'s (shape, dtype)."""
    got = {path: a for path, a in tree_leaves_with_path(dict(tree))}
    if set(got) != set(want):
        raise ValueError(f"{what} differs from model_spec: missing "
                         f"{sorted(set(want) - set(got))}, unknown "
                         f"{sorted(set(got) - set(want))}")
    flat = {}
    for path, (shape, dtype) in want.items():
        t = _leaf_tensor(got[path])
        if tuple(t.shape) != tuple(shape) or t.dtype != dtype:
            raise ValueError(f"{path}: want {dtype} {tuple(shape)}, got {t.dtype} "
                             f"{tuple(t.shape)}")
        flat[path] = t.to(dev)
    out: dict = {}
    for path, t in flat.items():
        *parents, name = path.split(".")
        node = out
        for p in parents:
            node = node.setdefault(p, {})
        node[name] = t
    return out


def _moments_want(cfg: ModelConfig, lead: tuple[int, ...] = ()) -> dict:
    return {path: ((*lead, *s.shape), torch.float32)
            for path, s in tree_leaves_with_path(model_spec(cfg))}


def opt_state_from_arrays(state, cfg: ModelConfig, *,
                          device: str | torch.device | None = None) -> OptState:
    """The port's ``OptState`` from the JAX package's (``step``, ``mu``,
    ``nu``; ``nu`` None for SGD), leaf for leaf: the moments are float32
    trees of ``cfg``'s parameter paths, the step a 0-dim int32."""
    dev = resolve_device(device)
    step = _leaf_tensor(state.step)
    if step.shape != () or step.dtype != torch.int32:
        raise ValueError(f"step: want a 0-dim int32, got {step.dtype} {tuple(step.shape)}")
    want = _moments_want(cfg)
    mu = _tree_from_arrays(state.mu, want, "optimizer state mu", dev)
    nu = None if state.nu is None else _tree_from_arrays(state.nu, want,
                                                         "optimizer state nu", dev)
    return OptState(step.to(dev), mu, nu)


def exchange_state_from_arrays(state, cfg: ModelConfig, num_groups: int, *,
                               device: str | torch.device | None = None) -> ExchangeState:
    """The port's ``ExchangeState`` from the JAX package's: float32 residuals
    of shape (num_groups, *param_shape) for each of ``cfg``'s parameters."""
    return ExchangeState(residual=_tree_from_arrays(
        state.residual, _moments_want(cfg, (num_groups,)), "exchange residuals",
        resolve_device(device)))
