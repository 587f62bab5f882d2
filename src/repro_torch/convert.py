"""Carry state across from the JAX package.

The JAX package's arrays (numpy views of its ``jax.Array`` results) become
the port's tensors here, so that both packages can compute on the same data:
a problem built by ``repro``, or a loop state (the server model, the duals,
the workers' residuals and the server's catch-up buffers) taken from a run.
Values are copied bit for bit; nothing is recomputed.
"""

from __future__ import annotations

from typing import Mapping

import numpy as np
import torch

from repro_torch.core.objectives import Problem
from repro_torch.device import resolve_device

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
