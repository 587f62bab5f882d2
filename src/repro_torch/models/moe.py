"""Mixture-of-Experts FFN with capacity-based dispatch (qwen3/jamba style).

PyTorch counterpart of ``repro.models.moe``, with its dispatch algorithm,
whose capacity semantics are the result: a softmax router, the top-k
experts of each token (renormalized with ``norm_topk_probs``), each
(token, choice) slot ranked within its expert by an exclusive cumsum over
the flattened (N*K, E) one-hot (token-major, choice k before k+1), slots
at rank >= C dropped with weight 0, one scatter-add into the (E, C, D)
buffer and one gather back per choice k, the experts' SwiGLU as three
batched products, and the K weighted outputs summed in order in the
compute dtype. The Switch-style load-balance term is returned beside the
output.

The JAX package splits the tokens into one dispatch group per data shard
of its mesh; the port has no mesh, so there is one group (G = 1), as in
JAX without one. Everything here is plain PyTorch: on the card it runs
cuBLAS's batched products and PyTorch's index kernels.
"""

from __future__ import annotations

from typing import NamedTuple

import torch
import torch.nn.functional as F

from repro_torch.models.config import ModelConfig
from repro_torch.models.param import ParamSpec


class Routing(NamedTuple):
    """The routing decisions of N tokens (G = 1)."""

    top_p: torch.Tensor  # (N, K) float32 combine weights before dropping
    top_e: torch.Tensor  # (N, K) int64 expert of each choice, best first
    pos: torch.Tensor  # (N, K) int32 rank of the slot within its expert
    keep: torch.Tensor  # (N, K) bool: pos < capacity
    aux: torch.Tensor  # () float32 load-balance loss


def moe_spec(cfg: ModelConfig) -> dict:
    d, f, e = cfg.d_model, cfg.d_ff_expert, cfg.num_experts
    dt = cfg.pdtype
    return {
        "router": ParamSpec((d, e), torch.float32, ("embed", None)),
        "gate": ParamSpec((e, d, f), dt, ("experts", "embed", "expert_ff")),
        "up": ParamSpec((e, d, f), dt, ("experts", "embed", "expert_ff")),
        "down": ParamSpec((e, f, d), dt, ("experts", "expert_ff", "embed")),
    }


def capacity(num_tokens: int, cfg: ModelConfig) -> int:
    """Slots per expert: ``int(N*K*cf/E) + 1`` rounded up to a multiple of 8,
    at least 8 (host arithmetic on config values, as in the JAX package)."""
    c = int(num_tokens * cfg.experts_per_token * cfg.moe_capacity_factor
            / cfg.num_experts) + 1
    return max(8, -(-c // 8) * 8)


def router_logits(params: dict, x: torch.Tensor) -> torch.Tensor:
    """(N, D) -> (N, E) float32 logits.

    The JAX package multiplies ``x`` by the router rounded to ``x``'s dtype
    and keeps the float32 accumulation (``preferred_element_type``). The
    products of two bf16 values are exact in float32, so the product of the
    two operands widened to float32 gives the same logits; a bf16 product
    would round them to bf16 and could flip the top-k."""
    return x.float() @ params["router"].to(x.dtype).float()


def route(params: dict, x: torch.Tensor, cfg: ModelConfig, cap: int) -> Routing:
    """Routing of ``x (N, D)`` into ``cap`` slots per expert."""
    E, K = cfg.num_experts, cfg.experts_per_token
    probs = torch.softmax(router_logits(params, x), dim=-1)
    top_p, top_e = torch.topk(probs, K, dim=-1, sorted=True)
    if cfg.norm_topk_probs:
        top_p = top_p / torch.clamp(top_p.sum(-1, keepdim=True), min=1e-9)

    # Load-balance auxiliary loss (Switch Transformer, eq. 4).
    me = probs.mean(0)
    ce = F.one_hot(top_e[:, 0], E).float().mean(0)
    aux = E * torch.sum(me * ce)

    # Rank of each (token, choice) within its expert: the exclusive cumsum
    # over the flattened (N*K, E) one-hot, token-major. The one-hot is laid
    # out expert-major, (E, N*K), so that the scan runs along contiguous
    # memory: PyTorch's scan over the outer dim of an (N*K, E) tensor took
    # 26 ms a layer at N*K = 65,536 on an H100, this one 0.11 ms. The ranks
    # are the same integers.
    e_flat = top_e.reshape(-1)
    onehot = e_flat[None, :] == torch.arange(E, device=x.device)[:, None]  # (E, N*K)
    inclusive = torch.cumsum(onehot, dim=1, dtype=torch.int32)
    pos = (inclusive.gather(0, e_flat[None, :])[0] - 1).reshape(top_e.shape)
    return Routing(top_p, top_e, pos, pos < cap, aux)


def moe(params: dict, x: torch.Tensor, cfg: ModelConfig) -> tuple[torch.Tensor, torch.Tensor]:
    """x (B, S, D) -> (out (B, S, D), aux_loss () float32)."""
    B, S, D = x.shape
    E, K = cfg.num_experts, cfg.experts_per_token
    N = B * S
    C = capacity(N, cfg)
    dt = x.dtype
    xf = x.reshape(N, D)
    r = route(params, xf, cfg, C)
    weight = torch.where(r.keep, r.top_p, 0.0)  # dropped slots contribute nothing
    slot = r.top_e * C + torch.clamp(r.pos, max=C - 1)  # (N, K) row of the (E*C, D) buffer

    # One scatter-add per routing choice k: the (N*K, D) token replication
    # is never made. A dropped slot adds zeros to its expert's last row.
    buf = torch.zeros(E * C, D, dtype=dt, device=x.device)
    for k in range(K):
        buf.index_add_(0, slot[:, k], xf * r.keep[:, k, None].to(dt))
    buf = buf.reshape(E, C, D)

    # The experts' SwiGLU as batched products over E.
    g = torch.bmm(buf, params["gate"].to(dt))
    u = torch.bmm(buf, params["up"].to(dt))
    y = torch.bmm(F.silu(g) * u, params["down"].to(dt)).reshape(E * C, D)

    # Gather back with the router weights, one (N, D) gather per choice.
    out = torch.zeros(N, D, dtype=dt, device=x.device)
    for k in range(K):
        out = out + y[slot[:, k]] * weight[:, k, None].to(dt)
    return out.reshape(B, S, D), r.aux
