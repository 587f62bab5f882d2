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

The held-experts path (:func:`moe_held`), which a
:class:`~repro_torch.models.config.HeldExpertsConfig` alone selects, is the
port's own: one expert-parallel share of a dropless layer. The router spans
all ``experts_total`` experts (a float32 softmax over :func:`router_logits`,
the top-k by probability, renormalised over the k); every (token, choice) pair
whose expert is held is computed by SwiGLU and weighted, and a pair of an
absent expert adds nothing. On the card the pairs are sorted by held
expert (absent pairs last) and the three products are grouped GEMMs
(``torch._grouped_mm``) whose group ends are device offsets: no size is read
to the host, so the layer makes no host sync. Its rows are the static
bound, every pair of the call, and the rows past the last held pair are
masked. On the CPU the plain path loops over the held experts at sizes read
to the host; a CUDA tensor never takes it. The layer returns its
load-balance statistics, each expert's share of the top-k choices and its
mean router probability, for ``train_loss`` to combine over all layers.
Spans ``moe.route``, ``moe.dispatch``, ``moe.experts`` and ``moe.combine``
time its parts; :data:`STATS` counts its calls, held rows and largest
expert's rows, the last two on the device.
"""

from __future__ import annotations

from typing import NamedTuple

import torch
import torch.nn.functional as F

from repro_torch.models.config import HeldExpertsConfig, ModelConfig
from repro_torch.models.param import ParamSpec
from repro_torch.tracing import span

# The held-experts path's counts since import: layer calls (host), and on the
# device the held (token, choice) rows and each call's largest held expert's
# rows, summed over calls. tracing.summary() reports their growth over a
# traced window ("moe"); nothing else reads the device counts. A replayed
# CUDA graph (launch/steps.py GradGraphs) runs no Python and counts nothing.
STATS: dict = {"calls": 0, "held_rows": 0, "largest_expert_rows": 0}


class Routing(NamedTuple):
    """The routing decisions of N tokens (G = 1)."""

    top_p: torch.Tensor  # (N, K) float32 combine weights before dropping
    top_e: torch.Tensor  # (N, K) int64 expert of each choice, best first
    pos: torch.Tensor  # (N, K) int32 rank of the slot within its expert
    keep: torch.Tensor  # (N, K) bool: pos < capacity
    aux: torch.Tensor  # () float32 load-balance loss


def moe_spec(cfg: ModelConfig) -> dict:
    """The router (D, experts it spans) and the experts held: all of them on
    the capacity path, ``num_experts`` of ``experts_total`` on the
    held-experts path."""
    d, f, e = cfg.d_model, cfg.d_ff_expert, cfg.num_experts
    dt = cfg.pdtype
    routed = cfg.experts_total if isinstance(cfg, HeldExpertsConfig) else e
    return {
        "router": ParamSpec((d, routed), torch.float32, ("embed", None)),
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


def moe_held(params: dict, x: torch.Tensor,
             cfg: HeldExpertsConfig) -> tuple[torch.Tensor, torch.Tensor]:
    """x (B, S, D) -> (out (B, S, D), stats (2, experts_total) float32): the
    held experts' part of the layer's output, and per expert its share of
    the top-k choices (summed over k, averaged over tokens) and its mean
    router probability, the second differentiable."""
    B, S, D = x.shape
    E, K, first = cfg.num_experts, cfg.experts_per_token, cfg.first_expert
    N = B * S
    dt = x.dtype
    xf = x.reshape(N, D)
    with span("moe.route", timed=True):
        probs = torch.softmax(router_logits(params, xf), dim=-1)  # (N, E_total)
        top_p, top_e = torch.topk(probs, K, dim=-1, sorted=True)
        if cfg.norm_topk_probs:
            top_p = top_p / torch.clamp(top_p.sum(-1, keepdim=True), min=1e-9)
        chosen = torch.zeros(cfg.experts_total, dtype=torch.float32, device=x.device)
        chosen.scatter_add_(0, top_e.reshape(-1), torch.ones(N * K, device=x.device))
        stats = torch.stack([chosen / N, probs.mean(0)])
        local = top_e - first
        held = (local >= 0) & (local < E)
        weight = torch.where(held, top_p, 0.0).to(dt)  # (N, K)
    with span("moe.dispatch", timed=True):
        # Each pair's held expert, or E for an absent one: sorted, the held
        # pairs come first, expert by expert, in pair order within each.
        key = torch.where(held, local, E).reshape(-1)  # (N*K,)
        counts = torch.zeros(E + 1, dtype=torch.int64, device=x.device)
        counts.scatter_add_(0, key, torch.ones_like(key))
        _count(counts[:E])
        if xf.is_cuda:
            order, ends, valid, rows = sort_pairs(xf, key, counts, K)
    with span("moe.experts", timed=True):
        if xf.is_cuda:
            y = grouped_swiglu(params, rows, ends, valid)
        else:
            y = experts_plain(params, xf, key, K)
    with span("moe.combine", timed=True):
        if xf.is_cuda:
            y = unsort(y, order)
        out = (y.reshape(N, K, D) * weight[..., None]).sum(1)
    return out.reshape(B, S, D), stats


def _count(counts: torch.Tensor) -> None:
    """Adds one call to :data:`STATS` (nothing while a CUDA graph captures)."""
    if counts.is_cuda and torch.cuda.is_current_stream_capturing():
        return
    STATS["calls"] += 1
    STATS["held_rows"] = STATS["held_rows"] + counts.sum()
    STATS["largest_expert_rows"] = STATS["largest_expert_rows"] + counts.max()


def experts_plain(params: dict, xf: torch.Tensor, key: torch.Tensor, K: int) -> torch.Tensor:
    """Each pair's expert output (N*K, D) in pair order, zero for an absent
    pair: a loop over the held experts at sizes read to the host. The CPU's
    path only."""
    if xf.is_cuda:
        raise RuntimeError("experts_plain reads sizes to the host; a CUDA tensor takes "
                           "the grouped GEMMs")
    dt = xf.dtype
    y = torch.zeros(key.numel(), xf.shape[1], dtype=dt, device=xf.device)
    for e in range(params["gate"].shape[0]):
        pairs = torch.nonzero(key == e)[:, 0]
        if pairs.numel():
            h = xf[pairs // K]
            h = F.silu(h @ params["gate"][e].to(dt)) * (h @ params["up"][e].to(dt))
            y = y.index_copy(0, pairs, h @ params["down"][e].to(dt))
    return y


def sort_pairs(xf: torch.Tensor, key: torch.Tensor, counts: torch.Tensor, K: int):
    """The pairs sorted by held expert, with no host sync: ``(order, ends,
    valid, rows)``, ``ends`` (E,) int32 each held expert's last row + 1,
    ``valid`` (N*K, 1) the rows of held pairs and ``rows`` (N*K, D) each
    sorted pair's token, zero past the held pairs. Every pair's row is
    gathered: the bound that the host knows."""
    M = key.numel()
    order = torch.argsort(key, stable=True)
    ends = torch.cumsum(counts[:-1], 0).to(torch.int32)
    valid = (torch.arange(M, device=xf.device) < ends[-1])[:, None]
    return order, ends, valid, torch.where(valid, xf[order // K], 0.0)


def grouped_swiglu(params: dict, rows: torch.Tensor, ends: torch.Tensor,
                   valid: torch.Tensor) -> torch.Tensor:
    """SwiGLU of each held expert over its rows as three grouped GEMMs
    (``torch._grouped_mm``, group ends ``ends``). The GEMM leaves the rows
    past the last group unwritten, in its output and in its input's
    gradient: they are zeroed in ``rows`` (whose gradient that masks) and in
    the output."""
    if not hasattr(torch, "_grouped_mm"):
        raise RuntimeError(f"torch {torch.__version__} has no _grouped_mm for the held "
                           "experts' products")
    dt = rows.dtype
    g = torch._grouped_mm(rows, params["gate"].to(dt), offs=ends)
    u = torch._grouped_mm(rows, params["up"].to(dt), offs=ends)
    y = torch._grouped_mm(F.silu(g) * u, params["down"].to(dt), offs=ends)
    return torch.where(valid, y, 0.0)


def unsort(y: torch.Tensor, order: torch.Tensor) -> torch.Tensor:
    """Rows in sorted order -> rows in pair order."""
    back = torch.empty_like(order)
    back[order] = torch.arange(order.numel(), device=order.device)
    return y[back]


def moe_layers(cfg: ModelConfig) -> int:
    """The number of MoE layers in the model."""
    return sum(periods * sum(l.mlp == "moe" for l in layout) for layout, periods in cfg.stages())


def load_balance(stats: torch.Tensor, cfg: HeldExpertsConfig) -> torch.Tensor:
    """transformers' ``load_balancing_loss_func`` from the layers' summed
    :func:`moe_held` statistics: over all layers' router outputs at once
    (each layer routes the same tokens, so the means over them are the means
    of the layers' means), ``experts_total`` x the sum over experts e and
    choices k of the share of rows whose k-th choice is e times e's mean
    router probability. The coefficient is the caller's."""
    share, prob = stats / moe_layers(cfg)
    return cfg.experts_total * torch.sum(share * prob)
