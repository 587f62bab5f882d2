"""Top-level causal LM: parameter plan, training loss, prefill and decode.

PyTorch counterpart of ``repro.models.model`` for text models built of
attention layers with dense MLPs. Parameters are the JAX package's tree as
nested dicts of tensors, path for path (``stage0.pos0.attn.wq``, ...), so
:func:`repro_torch.convert.params_from_arrays` carries JAX weights across
unchanged. The vision and audio frontends wait for their slice (ROADMAP A7).
"""

from __future__ import annotations

from typing import Any

import torch
import torch.nn.functional as F

from repro_torch.models import blocks
from repro_torch.models.blocks import AttnCache
from repro_torch.models.config import ModelConfig
from repro_torch.models.layers import (chunked_cross_entropy, embed, embedding_spec,
                                       lm_head_spec, logits, rmsnorm, rmsnorm_spec)


def _check_frontend(cfg: ModelConfig) -> None:
    if cfg.frontend != "text":
        raise NotImplementedError(f"the {cfg.frontend} frontend is not ported yet "
                                  "(ROADMAP A7)")


def model_spec(cfg: ModelConfig) -> dict:
    _check_frontend(cfg)
    spec: dict[str, Any] = {"embed": embedding_spec(cfg)}
    for si, (layout, periods) in enumerate(cfg.stages()):
        spec[f"stage{si}"] = blocks.stage_spec(cfg, layout, periods)
    spec["final_norm"] = rmsnorm_spec(cfg.d_model, "embed")
    spec["lm_head"] = lm_head_spec(cfg)
    return spec


def _input_embeds(params: dict, batch: dict, cfg: ModelConfig) -> torch.Tensor:
    _check_frontend(cfg)
    return embed(params["embed"], batch["tokens"], cfg)


def _forward_hidden(params, x, cfg, *, positions, caches=None, cache_len=None,
                    prefill=False, remat=False):
    new_caches = []
    for si, (layout, _) in enumerate(cfg.stages()):
        c = None if caches is None else caches[si]
        x, nc = blocks.stage_apply(params[f"stage{si}"], layout, x, cfg,
                                   positions=positions, caches=c, cache_len=cache_len,
                                   prefill=prefill, remat=remat)
        new_caches.append(nc)
    return rmsnorm(params["final_norm"], x, cfg.rmsnorm_eps), new_caches


def train_loss(params: dict, batch: dict, cfg: ModelConfig, *,
               remat: bool = True) -> torch.Tensor:
    """Scalar float32 training loss: the mean next-token NLL of ``batch``
    (``tokens``, ``labels`` (B, S)). The JAX package adds ``0.01 * aux``, the
    MoE load-balancing term, which is 0 for the dense families ported here."""
    x = _input_embeds(params, batch, cfg)
    S = x.shape[1]
    positions = torch.arange(S, device=x.device, dtype=torch.int32)[None, :]
    h, _ = _forward_hidden(params, x, cfg, positions=positions, remat=remat)
    return chunked_cross_entropy(params["lm_head"], h, batch["labels"], cfg)


def init_caches(cfg: ModelConfig, batch: int, max_seq: int, dtype: torch.dtype,
                device: str | torch.device) -> list:
    return [blocks.init_stage_caches(cfg, layout, periods, batch, max_seq, dtype,
                                     torch.device(device))
            for layout, periods in cfg.stages()]


def _assemble_attn_cache(raw_kv, S: int, max_seq: int) -> AttnCache:
    """Stacked raw (k, v) (periods, B, S, KV, hd) -> linear decode buffers."""
    k, v = raw_kv
    pad = (0, 0, 0, 0, 0, max_seq - S)  # zeros after the prompt, on the S axis
    return AttnCache(F.pad(k, pad), F.pad(v, pad))


@torch.no_grad()
def prefill(params: dict, batch: dict, cfg: ModelConfig, *, max_seq: int):
    """Run the prompt; return (last-position logits (B, V) float32, caches, S)."""
    x = _input_embeds(params, batch, cfg)
    B, S, _ = x.shape
    positions = torch.arange(S, device=x.device, dtype=torch.int32)[None, :]
    h, raw_caches = _forward_hidden(params, x, cfg, positions=positions, prefill=True)
    caches = [{key: _assemble_attn_cache(raw, S, max_seq) for key, raw in stage.items()}
              for stage in raw_caches]
    last = logits(params["lm_head"], h[:, -1:], cfg)[:, 0]
    return last, caches, S


@torch.no_grad()
def decode_step(params: dict, token: torch.Tensor, caches: list, cache_len: int,
                cfg: ModelConfig):
    """One serve step: token (B,) int, ``cache_len`` = prompt + generated count
    including this token. Returns (logits (B, V) float32, caches); the caches
    are updated in place."""
    x = embed(params["embed"], token[:, None], cfg)
    positions = torch.full((x.shape[0], 1), cache_len - 1, device=x.device,
                           dtype=torch.int32)
    h, new_caches = _forward_hidden(params, x, cfg, positions=positions, caches=caches,
                                    cache_len=cache_len)
    return logits(params["lm_head"], h[:, -1:], cfg)[:, 0], new_caches
