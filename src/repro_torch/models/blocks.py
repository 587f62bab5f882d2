"""Transformer/Mamba blocks and the multi-stage stack.

PyTorch counterpart of ``repro.models.blocks``. A *block* is one layer: a
pre-norm attention or SSD mixer, plus a pre-norm dense SwiGLU MLP, a MoE
sublayer, or nothing (``mlp="none"``), per its :class:`LayerSpec`. Under
the ``audio_conv`` frontend the norms are LayerNorm with a bias and the
dense MLP is GELU with biases (``models/layers.py``). A
*stage* is a stack of identical periods whose parameters are stacked over a
leading ``layers`` axis, as in the JAX package; where JAX scans, the port
loops over the periods in Python. It splits the stacks once per stage
(:func:`split_periods`: one ``unbind`` a stacked leaf, counted in
``STATS["stack_unbinds"]``), so the backward stacks a leaf's L period
gradients once, as the scan's does; indexing each period instead would send
back L zero-filled gradients of the whole stack and sum them, O(L^2) bytes
for an O(L) result. With ``remat``
(training) each period runs under ``torch.utils.checkpoint``
(non-reentrant), as JAX's ``jax.checkpoint`` of the scan body: its
activations are recomputed in the backward pass instead of kept. No
forward draws random numbers, so the checkpoint keeps no RNG state (which
would also bar a CUDA graph capture of the step, ``launch/steps.py``). Every
MoE block returns its load-balance term, summed over the stage in layer
order.

Caches: a full-attention layer keeps a (B, S_max, KV, hd) KV buffer; a
sliding-window layer whose window is shorter than S_max a ring of exactly
``window`` slots (position p in slot p % window), as in the JAX package;
an SSD layer an :class:`~repro_torch.models.ssm.SsmCache` (conv window,
state). A stage's caches are stacked over its periods. Decode writes into
them in place.
"""

from __future__ import annotations

from typing import Any, NamedTuple

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch.models import attention as attn_lib
from repro_torch.models import moe as moe_lib
from repro_torch.models import ssm as ssm_lib
from repro_torch.models.config import HeldExpertsConfig, LayerSpec, ModelConfig
from repro_torch.models.layers import mlp, mlp_spec, norm, norm_spec
from repro_torch.models.param import stack_specs, tree_leaves_with_path, tree_map
from repro_torch.models.ssm import SsmCache

# Stacked parameter leaves unbound into periods (split_periods), one per leaf
# per stage_apply call; a CUDA graph's replay runs no Python and counts none.
STATS = {"stack_unbinds": 0}


class AttnCache(NamedTuple):
    """KV buffer of one layer (or stacked over a stage's periods). It is a
    ring iff the layer has a window and S_buf == window (``_attn_decode``)."""

    k: torch.Tensor  # (B, S_buf, KV, hd)
    v: torch.Tensor


def block_spec(cfg: ModelConfig, layer: LayerSpec) -> dict:
    spec: dict[str, Any] = {"norm1": norm_spec(cfg, cfg.d_model, "embed")}
    if layer.kind == "attn":
        spec["attn"] = attn_lib.attention_spec(cfg)
    else:
        spec["ssm"] = ssm_lib.ssm_spec(cfg)
    if layer.mlp == "dense":
        spec["norm2"] = norm_spec(cfg, cfg.d_model, "embed")
        spec["mlp"] = mlp_spec(cfg)
    elif layer.mlp == "moe":
        spec["norm2"] = norm_spec(cfg, cfg.d_model, "embed")
        spec["moe"] = moe_lib.moe_spec(cfg)
    return spec


def block_apply(params: dict, layer: LayerSpec, x: torch.Tensor, cfg: ModelConfig, *,
                positions: torch.Tensor, cache: Any = None,
                cache_len: int | None = None, exploit_window: bool = True,
                prefill: bool = False):
    """Returns (x, new_cache, aux) with ``aux`` the float32 MoE load-balance
    term (a :class:`HeldExpertsConfig`'s: its (2, experts_total)
    statistics, ``moe.moe_held``), or None for a layer without MoE.
    ``prefill=True`` returns the raw cache of the whole sequence (attention:
    its (k, v); SSD: its :class:`SsmCache`) for the caller to assemble.
    ``exploit_window`` goes to the attention layer without a cache
    (``attention.attention``)."""
    aux = None
    h = norm(params["norm1"], x, cfg)
    if layer.kind == "attn":
        if cache is None:
            out, new_cache = attn_lib.attention(params["attn"], h, cfg, positions=positions,
                                                window=layer.window,
                                                exploit_window=exploit_window,
                                                return_kv=prefill)
        else:
            out, new_cache = _attn_decode(params["attn"], h, cfg, layer, cache, cache_len,
                                          positions)
    elif cache is None:
        if prefill:
            out, new_cache = ssm_lib.ssm_forward(params["ssm"], h, cfg, return_cache=True)
        else:
            out, new_cache = ssm_lib.ssm_forward(params["ssm"], h, cfg), None
    else:
        out, new_cache = ssm_lib.ssm_decode_step(params["ssm"], h, cache, cfg)
    x = x + out
    if layer.mlp == "dense":
        x = x + mlp(params["mlp"], norm(params["norm2"], x, cfg))
    elif layer.mlp == "moe":
        layer_fn = moe_lib.moe_held if isinstance(cfg, HeldExpertsConfig) else moe_lib.moe
        out2, aux = layer_fn(params["moe"], norm(params["norm2"], x, cfg), cfg)
        x = x + out2
    return x, new_cache, aux


def _attn_decode(params, h, cfg, layer: LayerSpec, cache: AttnCache, cache_len: int,
                 positions):
    """One-token decode against a linear or a ring KV buffer, updated in
    place. The ring writes slot ``(cache_len - 1) % window`` and attends over
    its ``min(cache_len, window)`` filled slots with no mask: the ring is
    the window."""
    S_buf = cache.k.shape[1]
    if layer.window is not None and S_buf == layer.window:
        slot, valid, window = (cache_len - 1) % S_buf, min(cache_len, S_buf), None
    else:
        slot, valid, window = cache_len - 1, cache_len, layer.window
    out, (k_buf, v_buf) = attn_lib.attention(
        params, h, cfg, positions=positions, window=window, cache=(cache.k, cache.v),
        cache_len=valid, slot=slot)
    return out, AttnCache(k_buf, v_buf)


def init_layer_cache(cfg: ModelConfig, layer: LayerSpec, batch: int, max_seq: int,
                     dtype: torch.dtype, device: torch.device) -> AttnCache | SsmCache:
    if layer.kind == "mamba":
        return ssm_lib.ssm_init_cache(cfg, batch, dtype, device)
    # A ring of `window` slots where the window is shorter than the context.
    s_buf = layer.window if layer.window is not None and layer.window < max_seq else max_seq
    shape = (batch, s_buf, cfg.num_kv_heads, cfg.resolved_head_dim)
    return AttnCache(torch.zeros(shape, dtype=dtype, device=device),
                     torch.zeros(shape, dtype=dtype, device=device))


def stage_spec(cfg: ModelConfig, layout: tuple[LayerSpec, ...], periods: int) -> dict:
    period = {f"pos{i}": block_spec(cfg, l) for i, l in enumerate(layout)}
    return stack_specs(period, periods)


def _period(cache: AttnCache | SsmCache, p: int) -> AttnCache | SsmCache:
    """Period ``p`` of a layer's caches stacked over periods (views, not
    copies). Indexed, not unbound: decode writes them in place, which
    autograd bars on the views of a multi-output op such as ``unbind``."""
    return type(cache)(*(t[p] for t in cache))


def _unbind(a: torch.Tensor) -> tuple[torch.Tensor, ...]:
    STATS["stack_unbinds"] += 1
    return a.unbind(0)


def split_periods(params: dict) -> list[dict]:
    """A stage's parameters period by period: each stacked leaf unbound once
    along its ``layers`` axis (views, not copies), so its gradient comes back
    through one ``UnbindBackward0`` that stacks the period gradients."""
    _, leaf = next(tree_leaves_with_path(params))
    split = tree_map(_unbind, params)
    return [tree_map(lambda parts: parts[p], split) for p in range(leaf.shape[0])]


def _stack(raws: list) -> Any:
    """Per-period raw prefill caches -> one stacked over periods."""
    stacked = [torch.stack(parts) for parts in zip(*raws)]
    return SsmCache(*stacked) if isinstance(raws[0], SsmCache) else tuple(stacked)


def _period_forward(p_params: dict, layout: tuple[LayerSpec, ...], x: torch.Tensor,
                    aux: torch.Tensor, cfg: ModelConfig, positions: torch.Tensor,
                    exploit_window: bool):
    """One period of the stack without caches (training): (x, aux)."""
    for i, layer in enumerate(layout):
        x, _, a = block_apply(p_params[f"pos{i}"], layer, x, cfg, positions=positions,
                              exploit_window=exploit_window)
        if a is not None:
            aux = aux + a
    return x, aux


def stage_apply(params: dict, layout: tuple[LayerSpec, ...], x: torch.Tensor,
                cfg: ModelConfig, *, positions: torch.Tensor, caches: dict | None = None,
                cache_len: int | None = None, prefill: bool = False, remat: bool = False,
                exploit_window: bool = True):
    """Run the stage's periods in order. Returns (x, new_caches, aux_sum).

    Prefill returns each layer's raw cache stacked over periods; decode
    returns ``caches`` itself, written in place; otherwise None. ``remat``
    (no caches, not prefill) recomputes each period in the backward pass.
    ``aux_sum`` adds the MoE blocks' load-balance terms (or statistics) in
    layer order to a float32 0 (the other blocks add 0 in the JAX package).
    """
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    raw: dict[str, list] = {f"pos{i}": [] for i in range(len(layout))}
    for p, p_params in enumerate(split_periods(params)):
        if remat and torch.is_grad_enabled():
            x, aux = checkpoint(_period_forward, p_params, layout, x, aux, cfg, positions,
                                exploit_window, use_reentrant=False, preserve_rng_state=False)
            continue
        for i, layer in enumerate(layout):
            key = f"pos{i}"
            c = None if caches is None else _period(caches[key], p)
            x, nc, a = block_apply(p_params[key], layer, x, cfg, positions=positions,
                                   cache=c, cache_len=cache_len,
                                   exploit_window=exploit_window, prefill=prefill)
            if a is not None:
                aux = aux + a
            if prefill:
                raw[key].append(nc)
    if prefill:  # each layer's list freed once stacked
        return x, {key: _stack(raw.pop(key)) for key in list(raw)}, aux
    return x, caches, aux


def init_stage_caches(cfg: ModelConfig, layout: tuple[LayerSpec, ...], periods: int,
                      batch: int, max_seq: int, dtype: torch.dtype,
                      device: torch.device) -> dict:
    out = {}
    for i, layer in enumerate(layout):
        one = init_layer_cache(cfg, layer, batch, max_seq, dtype, device)
        out[f"pos{i}"] = type(one)(*(t.expand(periods, *t.shape).clone() for t in one))
    return out
