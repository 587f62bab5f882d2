"""GQA attention: flash-kernel prefill and training, and decode over a KV cache.

PyTorch counterpart of ``repro.models.attention`` for layers with full or
sliding-window attention, with or without a logit softcap. Without a cache
(prefill and training) every layer goes through
``models.flash.flash_attention``, whose forward is
``kernels.ops.flash_attention_fwd`` (on the card, the hand-written kernel
``csrc/flash_attn.cu``, with the layer's window and the config's softcap)
and whose backward is FlashAttention-2's recomputation; decode attends one
query over the cache in plain PyTorch, as the JAX package does, over a
linear buffer (with the window's mask) or a ring of the window's last keys,
capping its scores as the JAX package's ``attend_cache`` does.

``exploit_window=False`` is the JAX package's §Perf baseline, which there
runs ``attend_blocked`` over every key with the window as a mask only.
Here it stays on the flash kernel (a CUDA tensor takes no plain path): its
full-range launch loads every tile up to the diagonal and masks, giving
the windowed launch's result bit for bit; the backward visits every
kv-block. Layers without a window, or with one at least S long, are
unchanged by it, as in JAX.

Scaling: ``_project_qkv`` pre-scales q by ``hd ** -0.5`` in the compute
dtype, as the JAX package does, and ``attention`` hands that q to the kernel
with ``sm_scale=1.0``, so q is scaled once and rounded as in JAX. The scale
is a Python float holding ``hd ** -0.5`` rounded to the compute dtype; where
``cfg.copies_attn_scale`` (the JAX package's decoders, ROADMAP G9) it is
first copied to the device as a 0-dim tensor of that dtype, the same product
bit for bit at one host sync a layer (``sync.attn_scale``).

The ``audio_conv`` frontend (HuBERT) adds a bias to each of q, k, v and
the output projection, scales q after its bias by the Python float, as
HuBERT's attention does (no copy to the device), and leaves RoPE out: that
frontend has added its positions to the stream (``models/audio.py``).
"""

from __future__ import annotations

import torch

from repro_torch.kernels.ref import NEG_INF
from repro_torch.models.config import ModelConfig
from repro_torch.models.flash import FlashSpec, flash_attention
from repro_torch.models.layers import rmsnorm, rope
from repro_torch.models.param import ParamSpec
from repro_torch.tracing import span


def attention_spec(cfg: ModelConfig) -> dict:
    d, hd = cfg.d_model, cfg.resolved_head_dim
    H, KV = cfg.num_heads, cfg.num_kv_heads
    dt = cfg.pdtype
    spec = {
        "wq": ParamSpec((d, H * hd), dt, ("embed", "heads")),
        "wk": ParamSpec((d, KV * hd), dt, ("embed", "kv_heads")),
        "wv": ParamSpec((d, KV * hd), dt, ("embed", "kv_heads")),
        "wo": ParamSpec((H * hd, d), dt, ("heads", "embed")),
    }
    if cfg.frontend == "audio_conv":
        spec.update(bq=ParamSpec((H * hd,), dt, ("heads",), init="zeros"),
                    bk=ParamSpec((KV * hd,), dt, ("kv_heads",), init="zeros"),
                    bv=ParamSpec((KV * hd,), dt, ("kv_heads",), init="zeros"),
                    bo=ParamSpec((d,), dt, ("embed",), init="zeros"))
    if cfg.qk_norm:
        spec["q_norm"] = {"scale": ParamSpec((hd,), torch.float32, (None,), init="ones")}
        spec["k_norm"] = {"scale": ParamSpec((hd,), torch.float32, (None,), init="ones")}
    return spec


def _project_qkv(params: dict, x: torch.Tensor, cfg: ModelConfig,
                 positions: torch.Tensor):
    """x (B,S,D) -> q (B,S,KV,G,hd) pre-scaled, k, v (B,S,KV,hd); RoPE'd + normed."""
    B, S, _ = x.shape
    hd = cfg.resolved_head_dim
    H, KV = cfg.num_heads, cfg.num_kv_heads
    dt = x.dtype
    q, k, v = (x @ params["wq"].to(dt)), (x @ params["wk"].to(dt)), (x @ params["wv"].to(dt))
    if "bq" in params:
        q, k, v = q + params["bq"].to(dt), k + params["bk"].to(dt), v + params["bv"].to(dt)
    q, k, v = q.reshape(B, S, H, hd), k.reshape(B, S, KV, hd), v.reshape(B, S, KV, hd)
    if cfg.qk_norm:
        q = rmsnorm(params["q_norm"], q, cfg.rmsnorm_eps)
        k = rmsnorm(params["k_norm"], k, cfg.rmsnorm_eps)
    if cfg.frontend != "audio_conv":
        q = rope(q, positions, cfg.rope_theta)
        k = rope(k, positions, cfg.rope_theta)
    q = q.reshape(B, S, KV, H // KV, hd)
    if cfg.frontend == "audio_conv":
        # HuBERT scales by a Python float, one rounding of the product.
        return q * hd**-0.5, k, v
    # The scale rounded to the compute dtype first, as a weakly typed Python
    # float is in JAX: q * hd^-0.5 rounds as the JAX package's does.
    scale = float(torch.tensor(hd**-0.5, dtype=dt))
    if cfg.copies_attn_scale:
        with span("sync.attn_scale"):  # a pageable copy to the device
            scale = torch.tensor(scale, dtype=dt, device=x.device)
    return q * scale, k, v


def attend_cache(q: torch.Tensor, k_cache: torch.Tensor, v_cache: torch.Tensor,
                 cfg: ModelConfig, *, cache_len: int, window: int | None = None) -> torch.Tensor:
    """Single-token decode attention over the first ``cache_len`` cache slots,
    and with a window only over the last ``window`` of them; float32 scores,
    capped by the config's softcap before the mask.

    q (B, 1, KV, G, hd) pre-scaled; caches (B, S_max, KV, hd). Returns
    (B, 1, KV, G, hd).
    """
    S_max = k_cache.shape[1]
    kpos = torch.arange(S_max, device=q.device)
    mask = kpos < cache_len
    if window is not None:
        mask = mask & (kpos >= cache_len - window)
    scores = torch.einsum("bqkgh,bskh->bkgqs", q, k_cache).float()
    cap = cfg.attn_logit_softcap
    if cap is not None:
        scores = cap * torch.tanh(scores / cap)
    scores = scores.masked_fill(~mask, NEG_INF)
    p = torch.softmax(scores, dim=-1)
    out = torch.einsum("bkgqs,bskh->bkgqh", p.to(q.dtype), v_cache)
    return out.permute(0, 3, 1, 2, 4)


def attention(params: dict, x: torch.Tensor, cfg: ModelConfig, *,
              positions: torch.Tensor, window: int | None,
              cache: tuple[torch.Tensor, torch.Tensor] | None = None,
              cache_len: int | None = None, slot: int | None = None,
              exploit_window: bool = True, return_kv: bool = False):
    """Attention layer, over a window of the last ``window`` keys if it is
    set. Returns (out (B,S,D), cache or None).

    Prefill and training (``cache=None``) go through the flash kernel (the
    backward's blocks are 512 by 512, the JAX package's defaults, but a
    sequence shorter than 768 is one block), with
    ``exploit_window`` passed to it (see the module docstring);
    ``return_kv=True`` also returns the projected (k, v) for the caller to
    assemble caches.
    Decode (``cache=(k_cache, v_cache)``, S == 1) writes the new token's k, v
    into ``slot`` (default ``cache_len - 1``) of the buffers in place, where
    the JAX package makes updated copies, attends over the first
    ``cache_len`` slots (and the window) and returns the same buffers; a
    ring buffer passes its slot, its filled length and no window
    (``blocks._attn_decode``).
    """
    B, S, _ = x.shape
    H, hd = cfg.num_heads, cfg.resolved_head_dim
    if positions.dim() == 1:
        positions = positions[None, :].expand(B, S)
    q, k, v = _project_qkv(params, x, cfg, positions)

    new_cache = None
    if cache is None:
        # Two blocks of 512 would pad a sequence of 513-767 rows to 1,024: HuBERT's
        # 562 frames would take 4 tile pairs of 512 x 512 where one of 562 x 562 does.
        block = S if S < 768 else 512
        spec = FlashSpec(causal=cfg.causal, window=window, block_q=block, block_k=block,
                         softcap=cfg.attn_logit_softcap, exploit_window=exploit_window)
        out = flash_attention(q.contiguous(), k.contiguous(), v.contiguous(), spec)
        if return_kv:
            new_cache = (k, v)
    else:
        if S != 1 or cache_len is None:
            raise ValueError("decode takes one token and its cache_len")
        k_cache, v_cache = cache
        slot = cache_len - 1 if slot is None else slot
        k_cache[:, slot] = k[:, 0]
        v_cache[:, slot] = v[:, 0]
        out = attend_cache(q, k_cache, v_cache, cfg, cache_len=cache_len, window=window)
        new_cache = (k_cache, v_cache)

    out = out.reshape(B, S, H * hd) @ params["wo"].to(x.dtype)
    if "bo" in params:
        out = out + params["bo"].to(x.dtype)
    return out, new_cache
