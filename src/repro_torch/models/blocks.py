"""Transformer blocks and the multi-stage stack.

PyTorch counterpart of ``repro.models.blocks`` for attention layers with a
dense MLP. A *block* is one layer: pre-norm attention, plus a pre-norm
SwiGLU MLP. A *stage* is a stack of identical periods whose parameters are
stacked over a leading ``layers`` axis, as in the JAX package; where JAX
scans, the port loops over the periods in Python and indexes the stacks.
With ``remat`` (training) each period runs under ``torch.utils.checkpoint``
(non-reentrant), as JAX's ``jax.checkpoint`` of the scan body: its
activations are recomputed in the backward pass instead of kept.
Mamba mixers and MoE MLPs raise ``NotImplementedError`` (ROADMAP A7), as
does the ring buffer of windowed layers.

KV caches: a full-attention layer keeps a (B, S_max, KV, hd) buffer; a
stage's caches are stacked over its periods, (periods, B, S_max, KV, hd).
Decode writes into them in place.
"""

from __future__ import annotations

from typing import Any, NamedTuple

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch.models import attention as attn_lib
from repro_torch.models.config import LayerSpec, ModelConfig
from repro_torch.models.layers import mlp, mlp_spec, rmsnorm, rmsnorm_spec
from repro_torch.models.param import stack_specs, tree_leaves_with_path, tree_map


class AttnCache(NamedTuple):
    """Linear KV buffer of one layer (or stacked over a stage's periods)."""

    k: torch.Tensor  # (B, S_buf, KV, hd)
    v: torch.Tensor


def _check_layer(layer: LayerSpec) -> None:
    if layer.kind != "attn":
        raise NotImplementedError(f"{layer.kind} layers are not ported yet (ROADMAP A7)")
    if layer.mlp == "moe":
        raise NotImplementedError("MoE MLPs are not ported yet (ROADMAP A7)")


def block_spec(cfg: ModelConfig, layer: LayerSpec) -> dict:
    _check_layer(layer)
    spec: dict[str, Any] = {"norm1": rmsnorm_spec(cfg.d_model, "embed"),
                            "attn": attn_lib.attention_spec(cfg)}
    if layer.mlp == "dense":
        spec["norm2"] = rmsnorm_spec(cfg.d_model, "embed")
        spec["mlp"] = mlp_spec(cfg)
    return spec


def block_apply(params: dict, layer: LayerSpec, x: torch.Tensor, cfg: ModelConfig, *,
                positions: torch.Tensor, cache: AttnCache | None = None,
                cache_len: int | None = None, prefill: bool = False):
    """Returns (x, new_cache). ``prefill=True`` returns the raw (k, v) of the
    whole sequence for the caller to assemble."""
    _check_layer(layer)
    h = rmsnorm(params["norm1"], x, cfg.rmsnorm_eps)
    if cache is None:
        out, new_cache = attn_lib.attention(params["attn"], h, cfg, positions=positions,
                                            window=layer.window, return_kv=prefill)
    else:
        out, new_cache = _attn_decode(params["attn"], h, cfg, layer, cache, cache_len,
                                      positions)
    x = x + out
    if layer.mlp == "dense":
        x = x + mlp(params["mlp"], rmsnorm(params["norm2"], x, cfg.rmsnorm_eps))
    return x, new_cache


def _attn_decode(params, h, cfg, layer: LayerSpec, cache: AttnCache, cache_len: int,
                 positions):
    """One-token decode against a linear KV buffer, updated in place."""
    if layer.window is not None and cache.k.shape[1] == layer.window:
        raise NotImplementedError("ring KV buffers of windowed layers are not "
                                  "ported yet (ROADMAP A7)")
    out, (k_buf, v_buf) = attn_lib.attention(
        params, h, cfg, positions=positions, window=layer.window,
        cache=(cache.k, cache.v), cache_len=cache_len)
    return out, AttnCache(k_buf, v_buf)


def init_layer_cache(cfg: ModelConfig, layer: LayerSpec, batch: int, max_seq: int,
                     dtype: torch.dtype, device: torch.device) -> AttnCache:
    _check_layer(layer)
    attn_lib.check_supported(cfg, layer.window)
    shape = (batch, max_seq, cfg.num_kv_heads, cfg.resolved_head_dim)
    return AttnCache(torch.zeros(shape, dtype=dtype, device=device),
                     torch.zeros(shape, dtype=dtype, device=device))


def stage_spec(cfg: ModelConfig, layout: tuple[LayerSpec, ...], periods: int) -> dict:
    period = {f"pos{i}": block_spec(cfg, l) for i, l in enumerate(layout)}
    return stack_specs(period, periods)


def _period(tree: Any, p: int) -> Any:
    """Period ``p`` of a tree stacked over periods (views, not copies)."""
    if isinstance(tree, AttnCache):
        return AttnCache(tree.k[p], tree.v[p])
    return tree_map(lambda a: a[p], tree)


def _period_forward(p_params: dict, layout: tuple[LayerSpec, ...], x: torch.Tensor,
                    cfg: ModelConfig, positions: torch.Tensor) -> torch.Tensor:
    """One period of the stack without caches (training)."""
    for i, layer in enumerate(layout):
        x, _ = block_apply(p_params[f"pos{i}"], layer, x, cfg, positions=positions)
    return x


def stage_apply(params: dict, layout: tuple[LayerSpec, ...], x: torch.Tensor,
                cfg: ModelConfig, *, positions: torch.Tensor, caches: dict | None = None,
                cache_len: int | None = None, prefill: bool = False, remat: bool = False):
    """Run the stage's periods in order. Returns (x, new_caches).

    Prefill returns each layer's raw (k, v) stacked over periods; decode
    returns ``caches`` itself, written in place; otherwise None. ``remat``
    (no caches, not prefill) recomputes each period in the backward pass.
    """
    _, leaf = next(tree_leaves_with_path(params))
    periods = leaf.shape[0]
    raw: dict[str, list] = {f"pos{i}": [] for i in range(len(layout))}
    for p in range(periods):
        p_params = _period(params, p)
        if remat and torch.is_grad_enabled():
            x = checkpoint(_period_forward, p_params, layout, x, cfg, positions,
                           use_reentrant=False)
            continue
        for i, layer in enumerate(layout):
            key = f"pos{i}"
            c = None if caches is None else _period(caches[key], p)
            x, nc = block_apply(p_params[key], layer, x, cfg, positions=positions,
                                cache=c, cache_len=cache_len, prefill=prefill)
            if prefill:
                raw[key].append(nc)
    if prefill:
        return x, {key: (torch.stack([k for k, _ in kv]), torch.stack([v for _, v in kv]))
                   for key, kv in raw.items()}
    return x, caches


def init_stage_caches(cfg: ModelConfig, layout: tuple[LayerSpec, ...], periods: int,
                      batch: int, max_seq: int, dtype: torch.dtype,
                      device: torch.device) -> dict:
    out = {}
    for i, layer in enumerate(layout):
        one = init_layer_cache(cfg, layer, batch, max_seq, dtype, device)
        out[f"pos{i}"] = AttnCache(one.k.expand(periods, *one.k.shape).clone(),
                                   one.v.expand(periods, *one.v.shape).clone())
    return out
