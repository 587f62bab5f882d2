"""AdamW and SGD (+momentum) with cosine, linear or constant schedules.

PyTorch counterpart of ``repro.optim.optimizers``: the same config, state
and arithmetic. Moments are float32; each update is computed in float32
from the parameter's float32 value and cast back to the parameter's dtype,
as in the JAX package, and leaves are visited in its order (dict keys
sorted), so the global norm sums them in the same order.

Where JAX returns new arrays, :func:`apply_update` writes the new
parameters and moments into the tensors it was given (one leaf at a time,
so the float32 temporaries are those of the largest leaf) and returns
them: at full width the moments are 8 bytes a parameter, and a second copy
would not fit beside the exchange's residuals. The step counter is a 0-dim
int32 tensor on the parameters' device; nothing here syncs with the host.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, NamedTuple

import torch

from repro_torch.models.param import tree_flatten, tree_map

PyTree = Any


@dataclasses.dataclass(frozen=True)
class OptimizerConfig:
    name: str = "adamw"  # "adamw" | "sgd"
    learning_rate: float = 3e-4
    warmup_steps: int = 100
    total_steps: int = 10_000
    schedule: str = "cosine"  # "cosine" | "linear" | "constant"
    beta1: float = 0.9
    beta2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.01
    momentum: float = 0.9
    grad_clip: float = 1.0


class OptState(NamedTuple):
    step: torch.Tensor  # 0-dim int32
    mu: PyTree  # first moment / momentum, float32
    nu: PyTree | None  # second moment (adamw only), float32


def lr_at(cfg: OptimizerConfig, step: torch.Tensor) -> torch.Tensor:
    """The learning rate at ``step`` (a tensor), float32."""
    step = step.to(torch.float32)
    warm = torch.clamp(step / max(cfg.warmup_steps, 1), max=1.0)
    frac = torch.clamp((step - cfg.warmup_steps) / max(cfg.total_steps - cfg.warmup_steps, 1),
                       0.0, 1.0)
    if cfg.schedule == "cosine":
        decay = 0.5 * (1.0 + torch.cos(math.pi * frac))
    elif cfg.schedule == "linear":
        decay = 1.0 - frac
    else:
        decay = torch.ones_like(step)
    return cfg.learning_rate * warm * decay


def global_norm(grads: PyTree) -> torch.Tensor:
    """sqrt of the float32 sum of squares of every leaf, in the JAX order."""
    leaves, _ = tree_flatten(grads)
    total = torch.zeros((), dtype=torch.float32, device=leaves[0].device)
    for g in leaves:
        total = total + torch.sum(torch.square(g.to(torch.float32)))
    return torch.sqrt(total)


def _clip_scale(gnorm: torch.Tensor, max_norm: float) -> torch.Tensor:
    return torch.clamp(max_norm / torch.clamp(gnorm, min=1e-12), max=1.0)


def clip_by_global_norm(grads: PyTree, max_norm: float) -> tuple[PyTree, torch.Tensor]:
    """(grads scaled to at most ``max_norm`` in global norm, in their dtypes; the norm)."""
    gnorm = global_norm(grads)
    scale = _clip_scale(gnorm, max_norm)
    return tree_map(lambda g: (g.to(torch.float32) * scale).to(g.dtype), grads), gnorm


def init_state(cfg: OptimizerConfig, params: PyTree) -> OptState:
    leaves, _ = tree_flatten(params)
    device = leaves[0].device

    def zeros():
        return tree_map(lambda p: torch.zeros(p.shape, dtype=torch.float32,
                                              device=p.device), params)

    step = torch.zeros((), dtype=torch.int32, device=device)
    if cfg.name == "adamw":
        return OptState(step, zeros(), zeros())
    if cfg.name == "sgd":
        return OptState(step, zeros(), None)
    raise ValueError(cfg.name)


@torch.no_grad()
def apply_update(cfg: OptimizerConfig, params: PyTree, grads: PyTree,
                 state: OptState) -> tuple[PyTree, OptState, dict]:
    """One optimizer step, in place (see the module docstring); grads may be
    any tree matching params, in any float dtype. Returns (params, state,
    {"lr", "grad_norm"})."""
    if cfg.name not in ("adamw", "sgd"):
        raise ValueError(cfg.name)
    gnorm = global_norm(grads)
    scale = _clip_scale(gnorm, cfg.grad_clip)
    step = state.step + 1
    lr = lr_at(cfg, step)
    p_leaves, _ = tree_flatten(params)
    g_leaves, _ = tree_flatten(grads)
    m_leaves, _ = tree_flatten(state.mu)
    if cfg.name == "sgd":
        for p, g, m in zip(p_leaves, g_leaves, m_leaves):
            g32 = (g.to(torch.float32) * scale).to(g.dtype).to(torch.float32)
            m.mul_(cfg.momentum).add_(g32)
            p32 = p.to(torch.float32)
            p.copy_((p32 - lr * (m + cfg.weight_decay * p32)).to(p.dtype))
        return params, OptState(step, state.mu, None), {"lr": lr, "grad_norm": gnorm}

    b1, b2 = cfg.beta1, cfg.beta2
    t = step.to(torch.float32)
    c1, c2 = 1 - torch.pow(b1, t), 1 - torch.pow(b2, t)
    v_leaves, _ = tree_flatten(state.nu)
    for p, g, m, v in zip(p_leaves, g_leaves, m_leaves, v_leaves):
        g32 = (g.to(torch.float32) * scale).to(g.dtype).to(torch.float32)
        m.mul_(b1).add_((1 - b1) * g32)
        v.mul_(b2).add_((1 - b2) * torch.square(g32))
        del g32
        p32 = p.to(torch.float32)
        delta = (m / c1) / (torch.sqrt(v / c2) + cfg.eps) + cfg.weight_decay * p32
        p.copy_((p32 - lr * delta).to(p.dtype))
    return params, OptState(step, state.mu, state.nu), {"lr": lr, "grad_norm": gnorm}
