"""Top-level causal LM: parameter plan, training loss, prefill and decode.

PyTorch counterpart of ``repro.models.model`` for text models: attention
and SSD (Mamba2) mixers with dense, MoE or no MLP sublayers. Parameters are
the JAX package's tree as nested dicts of tensors, path for path
(``stage0.pos0.attn.wq``, ...), so
:func:`repro_torch.convert.params_from_arrays` carries JAX weights across
unchanged. The vision and audio frontends wait for their slice (ROADMAP A7).
"""

from __future__ import annotations

from typing import Any

import torch
import torch.nn.functional as F

from repro_torch.models import blocks
from repro_torch.models.blocks import AttnCache
from repro_torch.models.config import LayerSpec, ModelConfig
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
    """(final-normed hidden states, caches per stage, summed float32 aux)."""
    aux_total = torch.zeros((), dtype=torch.float32, device=x.device)
    new_caches = []
    for si, (layout, _) in enumerate(cfg.stages()):
        c = None if caches is None else caches[si]
        x, nc, aux = blocks.stage_apply(params[f"stage{si}"], layout, x, cfg,
                                        positions=positions, caches=c, cache_len=cache_len,
                                        prefill=prefill, remat=remat)
        new_caches.append(nc)
        aux_total = aux_total + aux
    return rmsnorm(params["final_norm"], x, cfg.rmsnorm_eps), new_caches, aux_total


def train_loss(params: dict, batch: dict, cfg: ModelConfig, *, remat: bool = True,
               aux_weight: float = 0.01) -> torch.Tensor:
    """Scalar float32 training loss of ``batch`` (``tokens``, ``labels``
    (B, S)): the mean next-token NLL plus ``aux_weight`` times the MoE
    load-balance terms summed over the layers, as in the JAX package (the
    sum is 0 without MoE layers)."""
    x = _input_embeds(params, batch, cfg)
    S = x.shape[1]
    positions = torch.arange(S, device=x.device, dtype=torch.int32)[None, :]
    h, _, aux = _forward_hidden(params, x, cfg, positions=positions, remat=remat)
    nll = chunked_cross_entropy(params["lm_head"], h, batch["labels"], cfg)
    return nll + aux_weight * aux


def init_caches(cfg: ModelConfig, batch: int, max_seq: int, dtype: torch.dtype,
                device: str | torch.device) -> list:
    return [blocks.init_stage_caches(cfg, layout, periods, batch, max_seq, dtype,
                                     torch.device(device))
            for layout, periods in cfg.stages()]


def _assemble_cache(raw, layer: LayerSpec, S: int, max_seq: int):
    """A layer's raw prefill cache, stacked over periods, -> its decode cache:
    (k, v) (periods, B, S, KV, hd) -> linear buffers of ``max_seq`` slots; an
    SSD layer's :class:`SsmCache` is already in decode form."""
    if layer.kind != "attn":
        return raw
    k, v = raw
    pad = (0, 0, 0, 0, 0, max_seq - S)  # zeros after the prompt, on the S axis
    return AttnCache(F.pad(k, pad), F.pad(v, pad))


@torch.no_grad()
def prefill(params: dict, batch: dict, cfg: ModelConfig, *, max_seq: int):
    """Run the prompt; return (last-position logits (B, V) float32, caches, S)."""
    x = _input_embeds(params, batch, cfg)
    B, S, _ = x.shape
    positions = torch.arange(S, device=x.device, dtype=torch.int32)[None, :]
    h, raw_caches, _ = _forward_hidden(params, x, cfg, positions=positions, prefill=True)
    caches = [{f"pos{i}": _assemble_cache(stage[f"pos{i}"], layer, S, max_seq)
               for i, layer in enumerate(layout)}
              for (layout, _), stage in zip(cfg.stages(), raw_caches)]
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
    h, new_caches, _ = _forward_hidden(params, x, cfg, positions=positions, caches=caches,
                                       cache_len=cache_len)
    return logits(params["lm_head"], h[:, -1:], cfg)[:, 0], new_caches
