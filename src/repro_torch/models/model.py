"""Top-level models: parameter plan, training loss, prefill and decode.

PyTorch counterpart of ``repro.models.model``: causal LMs with attention
(full or sliding-window) and SSD (Mamba2) mixers with dense, MoE or no MLP
sublayers, the VLM and the encoder-only audio model. Parameters are the JAX
package's tree as nested dicts of tensors, path for path
(``stage0.pos0.attn.wq``, ...), so
:func:`repro_torch.convert.params_from_arrays` carries JAX weights across
unchanged.

Modality frontends, as in the JAX package (its one allowed stub): a VLM
batch carries precomputed ``patch_embeds`` (B, P, d_model) and an audio
batch ``frame_embeds`` (B, S, d_model); a learned linear ``projector`` maps
them into the stream, the patches before the text tokens. The VLM's loss is
taken on the text positions only; the audio model is encoder-only and has
no decode step.

The port's published audio path, ``frontend="audio_conv"``
(:class:`~repro_torch.models.config.ConvAudioConfig`, ``models/audio.py``):
a batch carries float32 samples ``waveform`` (B, n), a ``mask`` (B, S) of
the frames to predict and their units ``labels`` (B, S); the conv feature
encoder, the mask embedding and the positional conv make the stream, and
``train_loss`` is HuBERT's masked-unit loss. It trains only.
"""

from __future__ import annotations

from typing import Any

import torch
import torch.nn.functional as F

from repro_torch.models import audio, blocks, moe
from repro_torch.models.blocks import AttnCache
from repro_torch.models.config import HeldExpertsConfig, LayerSpec, ModelConfig
from repro_torch.models.layers import (chunked_cross_entropy, embed, embedding_spec,
                                       lm_head_spec, logits, norm, norm_spec)
from repro_torch.models.param import ParamSpec


def model_spec(cfg: ModelConfig) -> dict:
    spec: dict[str, Any] = {}
    if cfg.frontend in ("text", "vision_stub"):
        spec["embed"] = embedding_spec(cfg)  # the VLM's text side too
    if cfg.frontend in ("vision_stub", "audio_stub"):
        spec["projector"] = {
            "w": ParamSpec((cfg.d_model, cfg.d_model), cfg.pdtype, ("embed", None))}
    if cfg.frontend == "audio_conv":
        spec["frontend"] = audio.frontend_spec(cfg)
    for si, (layout, periods) in enumerate(cfg.stages()):
        spec[f"stage{si}"] = blocks.stage_spec(cfg, layout, periods)
    spec["final_norm"] = norm_spec(cfg, cfg.d_model, "embed")
    if cfg.frontend == "audio_conv":
        spec["head"] = audio.head_spec(cfg)
    else:
        spec["lm_head"] = lm_head_spec(cfg)
    return spec


def _project(params: dict, x: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    """Precomputed patch or frame embeddings through the projector, in the
    compute dtype."""
    dt = cfg.cdtype
    return x.to(dt) @ params["projector"]["w"].to(dt)


def _input_embeds(params: dict, batch: dict, cfg: ModelConfig) -> torch.Tensor:
    if cfg.frontend == "text":
        return embed(params["embed"], batch["tokens"], cfg)
    if cfg.frontend == "vision_stub":
        text = embed(params["embed"], batch["tokens"], cfg)
        patches = _project(params, batch["patch_embeds"], cfg)
        return torch.cat([patches, text], dim=1)  # image tokens first
    if cfg.frontend == "audio_stub":
        return _project(params, batch["frame_embeds"], cfg)
    raise ValueError(cfg.frontend)


def _forward_hidden(params, x, cfg, *, positions, caches=None, cache_len=None,
                    remat=False, exploit_window=True, prefill=False):
    """(final-normed hidden states, caches per stage, summed float32 aux)."""
    aux_total = torch.zeros((), dtype=torch.float32, device=x.device)
    new_caches = []
    for si, (layout, _) in enumerate(cfg.stages()):
        c = None if caches is None else caches[si]
        x, nc, aux = blocks.stage_apply(params[f"stage{si}"], layout, x, cfg,
                                        positions=positions, caches=c, cache_len=cache_len,
                                        prefill=prefill, remat=remat,
                                        exploit_window=exploit_window)
        new_caches.append(nc)
        aux_total = aux_total + aux
    return norm(params["final_norm"], x, cfg), new_caches, aux_total


def train_loss(params: dict, batch: dict, cfg: ModelConfig, *, remat: bool = True,
               exploit_window: bool = True, aux_weight: float = 0.01) -> torch.Tensor:
    """Scalar float32 training loss of ``batch`` (``labels`` (B, S) and the
    frontend's inputs: ``tokens``, ``patch_embeds`` before them, or
    ``frame_embeds``): the mean next-token NLL (for the VLM over the text
    positions only) plus ``aux_weight`` times the MoE load-balance terms
    summed over the layers, as in the JAX package (the sum is 0 without MoE
    layers); a :class:`HeldExpertsConfig` adds its published load-balance
    term at its own coefficient instead (``moe.load_balance``).
    ``exploit_window=False`` runs the windowed layers as the JAX package's
    baseline of that name (``models.attention``): the same loss.
    ``frontend="audio_conv"``: HuBERT's masked-unit loss of ``waveform``,
    ``mask`` and ``labels`` (``models/audio.py``)."""
    if cfg.frontend == "audio_conv":
        return _masked_unit_loss(params, batch, cfg, remat=remat,
                                 exploit_window=exploit_window, aux_weight=aux_weight)
    x = _input_embeds(params, batch, cfg)
    S = x.shape[1]
    positions = torch.arange(S, device=x.device, dtype=torch.int32)[None, :]
    h, _, aux = _forward_hidden(params, x, cfg, positions=positions, remat=remat,
                                exploit_window=exploit_window)
    if cfg.frontend == "vision_stub":  # the loss after the patch prefix
        h = h[:, batch["patch_embeds"].shape[1]:]
    nll = chunked_cross_entropy(params["lm_head"], h, batch["labels"], cfg)
    if isinstance(cfg, HeldExpertsConfig):
        return nll + cfg.load_balance_coef * moe.load_balance(aux, cfg)
    return nll + aux_weight * aux


def _masked_unit_loss(params: dict, batch: dict, cfg: ModelConfig, *, remat: bool,
                      exploit_window: bool, aux_weight: float) -> torch.Tensor:
    x, penalty = audio.embed_frames(params["frontend"], batch["waveform"], batch["mask"], cfg)
    x = audio.pos_conv(params["frontend"], x, cfg)
    positions = torch.arange(x.shape[1], device=x.device, dtype=torch.int32)[None, :]
    h, _, aux = _forward_hidden(params, x, cfg, positions=positions, remat=remat,
                                exploit_window=exploit_window)
    loss = audio.head_loss(params["head"], h, batch["labels"], batch["mask"], penalty, cfg)
    return loss + aux_weight * aux


def init_caches(cfg: ModelConfig, batch: int, max_seq: int, dtype: torch.dtype,
                device: str | torch.device) -> list:
    return [blocks.init_stage_caches(cfg, layout, periods, batch, max_seq, dtype,
                                     torch.device(device))
            for layout, periods in cfg.stages()]


def _assemble_cache(raw, layer: LayerSpec, S: int, max_seq: int):
    """A layer's raw prefill cache, stacked over periods, -> its decode cache:
    (k, v) (periods, B, S, KV, hd) -> linear buffers of ``max_seq`` slots, or
    for a window shorter than ``max_seq`` a ring of ``window`` slots holding
    the last ``min(S, window)`` positions, position p in slot p % window; an
    SSD layer's :class:`SsmCache` is already in decode form."""
    if layer.kind != "attn":
        return raw
    k, v = raw
    W = layer.window
    if W is not None and W < max_seq:
        take = min(S, W)
        slots = (torch.arange(S - take, S, device=k.device) % W)
        shape = (*k.shape[:2], W, *k.shape[3:])
        k_buf, v_buf = k.new_zeros(shape), v.new_zeros(shape)
        k_buf[:, :, slots] = k[:, :, S - take:]
        v_buf[:, :, slots] = v[:, :, S - take:]
        return AttnCache(k_buf, v_buf)
    pad = (0, 0, 0, 0, 0, max_seq - S)  # zeros after the prompt, on the S axis
    return AttnCache(F.pad(k, pad), F.pad(v, pad))


@torch.no_grad()
def prefill(params: dict, batch: dict, cfg: ModelConfig, *, max_seq: int,
            exploit_window: bool = True):
    """Run the prompt; return (last-position logits (B, V) float32, caches, S).

    ``batch`` holds the frontend's inputs (``tokens``; ``patch_embeds`` and
    ``tokens``; ``frame_embeds``); S counts every position of the stream, a
    VLM's patches too, and ``max_seq`` must hold S plus the steps to come.
    ``exploit_window=False`` is the JAX package's windowed baseline
    (``models.attention``): the same logits and caches.
    """
    x = _input_embeds(params, batch, cfg)
    B, S, _ = x.shape
    positions = torch.arange(S, device=x.device, dtype=torch.int32)[None, :]
    h, raw_caches, _ = _forward_hidden(params, x, cfg, positions=positions, prefill=True,
                                       exploit_window=exploit_window)
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
    are updated in place. An encoder-only model raises ``ValueError``."""
    if cfg.frontend in ("audio_stub", "audio_conv"):
        raise ValueError("encoder-only model has no decode step")
    x = embed(params["embed"], token[:, None], cfg)
    positions = torch.full((x.shape[0], 1), cache_len - 1, device=x.device,
                           dtype=torch.int32)
    h, new_caches, _ = _forward_hidden(params, x, cfg, positions=positions, caches=caches,
                                       cache_len=cache_len)
    return logits(params["lm_head"], h[:, -1:], cfg)[:, 0], new_caches
