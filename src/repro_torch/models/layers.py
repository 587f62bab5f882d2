"""Shared neural layers: RMSNorm, RoPE, SwiGLU MLP, embedding and LM head.

PyTorch counterpart of ``repro.models.layers``, with the same dtype
handling: norms and RoPE compute in float32 and cast back to the input's
dtype; the matrix products run in the compute dtype; logits are float32.
``chunked_cross_entropy`` waits for the training slice (ROADMAP A11).
"""

from __future__ import annotations

import torch

from repro_torch.models.config import ModelConfig
from repro_torch.models.param import ParamSpec


def rmsnorm_spec(dim: int, axis: str | None = None) -> dict:
    return {"scale": ParamSpec((dim,), torch.float32, (axis,), init="ones")}


def rmsnorm(params: dict, x: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    xf = x.float()
    var = torch.mean(xf * xf, dim=-1, keepdim=True)
    y = xf * torch.rsqrt(var + eps) * params["scale"].float()
    return y.to(x.dtype)


def rope(x: torch.Tensor, positions: torch.Tensor, theta: float) -> torch.Tensor:
    """x: (..., S, n_heads, head_dim); positions: broadcastable to (..., S)."""
    half = x.shape[-1] // 2
    freqs = theta ** (-torch.arange(0, half, dtype=torch.float32, device=x.device) / half)
    angles = positions[..., None].float() * freqs  # (..., S, half)
    cos = torch.cos(angles)[..., None, :]  # (..., S, 1, half)
    sin = torch.sin(angles)[..., None, :]
    x1, x2 = x[..., :half].float(), x[..., half:].float()
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


def mlp_spec(cfg: ModelConfig) -> dict:
    d, f, dt = cfg.d_model, cfg.d_ff, cfg.pdtype
    return {
        "gate": ParamSpec((d, f), dt, ("embed", "ff")),
        "up": ParamSpec((d, f), dt, ("embed", "ff")),
        "down": ParamSpec((f, d), dt, ("ff", "embed")),
    }


def mlp(params: dict, x: torch.Tensor) -> torch.Tensor:
    dt = x.dtype
    g = x @ params["gate"].to(dt)
    u = x @ params["up"].to(dt)
    return (torch.nn.functional.silu(g) * u) @ params["down"].to(dt)


def embedding_spec(cfg: ModelConfig) -> dict:
    return {"table": ParamSpec((cfg.vocab_size, cfg.d_model), cfg.pdtype,
                               ("vocab", "embed"), scale=1.0)}


def embed(params: dict, tokens: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    return params["table"].to(cfg.cdtype)[tokens]


def lm_head_spec(cfg: ModelConfig) -> dict:
    return {"out": ParamSpec((cfg.d_model, cfg.vocab_size), cfg.pdtype,
                             ("embed", "vocab"))}


def logits(params: dict, h: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    return (h @ params["out"].to(h.dtype)).float()
