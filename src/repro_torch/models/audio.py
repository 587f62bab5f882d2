"""HuBERT's waveform frontend and masked-unit head (``frontend="audio_conv"``).

The published model (HuBERT, Hsu et al., arXiv:2106.07447; its encoder is
wav2vec 2.0's, arXiv:2006.11477, in the ``do_stable_layer_norm`` form of
the X-Large model), around the block stack of ``models/blocks.py``:

* the conv feature encoder on float32 samples (B, n): per layer a
  ``conv1d`` with a bias, LayerNorm over its channels with affine weights
  and GELU; S = 1 + (n - 400) // 320 frames for HuBERT's kernels and
  strides (the receptive field and the product of the strides);
* the feature penalty, the encoder output's mean square in float32;
* LayerNorm over the features, a projection to ``d_model``, and each
  masked frame replaced by the learned ``mask_emb``;
* the positional conv: x + GELU(conv1d(x)) over ``num_conv_pos_embeddings``
  taps in ``num_conv_pos_embedding_groups`` groups, padded by half the
  kernel on each side and its last output frame dropped (an even kernel),
  its weight normed as ``weight_norm(dim=2)``: w = g v / ||v|| with the
  norm over the output and input channels of each tap;
* the head (fairseq's ``HubertModel`` with ``untie_final_proj`` off): the
  final hidden states through ``final_proj`` (D -> ``final_dim``), cosine
  similarity with each of ``vocab_size`` unit embeddings over
  ``logit_temp``, cross-entropy against the frame's unit averaged over the
  masked frames, plus ``feature_penalty`` times the feature penalty.

Dropout and layer drop are off. The convolutions and products run in the
compute dtype, the norms, the cosine logits and the loss in float32.

Spans (timed on the card): ``audio.frontend`` (conv encoder, feature norm,
projection, mask), ``audio.posconv`` and ``audio.head``. The model calls
:func:`pos_conv` and :func:`head_loss` through this module, so that a
caller may swap either.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from repro_torch.models.config import ConvAudioConfig
from repro_torch.models.layers import layernorm, layernorm_spec
from repro_torch.models.param import ParamSpec
from repro_torch.tracing import span

CONV_NORM_EPS = 1e-5  # the conv layers' LayerNorm: torch's default, as published


def frontend_spec(cfg: ConvAudioConfig) -> dict:
    dt, D, K = cfg.pdtype, cfg.d_model, cfg.num_conv_pos_embeddings
    spec: dict = {}
    c_in = 1
    for i, (c, k) in enumerate(zip(cfg.conv_dim, cfg.conv_kernel)):
        spec[f"conv{i}"] = {"w": ParamSpec((c, c_in, k), dt, (None, None, None),
                                           scale=1 / math.sqrt(c_in * k)),
                            "b": ParamSpec((c,), dt, (None,), init="zeros"),
                            "norm": layernorm_spec(c)}
        c_in = c
    per_group = D // cfg.num_conv_pos_embedding_groups
    spec["feat_norm"] = layernorm_spec(c_in)
    spec["proj"] = {"w": ParamSpec((c_in, D), dt, (None, "embed")),
                    "b": ParamSpec((D,), dt, ("embed",), init="zeros")}
    spec["mask_emb"] = ParamSpec((D,), dt, ("embed",))
    spec["pos_conv"] = {"g": ParamSpec((1, 1, K), dt, (None, None, None), init="ones"),
                        "v": ParamSpec((D, per_group, K), dt, ("embed", None, None),
                                       scale=1 / math.sqrt(per_group * K)),
                        "b": ParamSpec((D,), dt, ("embed",), init="zeros")}
    return spec


def head_spec(cfg: ConvAudioConfig) -> dict:
    dt, D, E = cfg.pdtype, cfg.d_model, cfg.final_dim
    return {"proj": {"w": ParamSpec((D, E), dt, ("embed", None)),
                     "b": ParamSpec((E,), dt, (None,), init="zeros")},
            "label_embs": ParamSpec((cfg.vocab_size, E), dt, ("vocab", None))}


def conv_features(params: dict, wave: torch.Tensor, cfg: ConvAudioConfig) -> torch.Tensor:
    """Samples (B, n) -> the conv encoder's output (B, S, C) in the compute dtype."""
    dt = cfg.cdtype
    x = wave.to(dt)[:, None, :]
    last = len(cfg.conv_dim) - 1
    for i, stride in enumerate(cfg.conv_stride):
        p = params[f"conv{i}"]
        x = F.conv1d(x, p["w"].to(dt), p["b"].to(dt), stride=stride)
        x = F.gelu(layernorm(p["norm"], x.transpose(1, 2), CONV_NORM_EPS))
        if i < last:
            x = x.transpose(1, 2)
    return x


def embed_frames(params: dict, wave: torch.Tensor, mask: torch.Tensor,
                 cfg: ConvAudioConfig) -> tuple[torch.Tensor, torch.Tensor]:
    """(frames (B, S, D) in the compute dtype with ``mask_emb`` at the masked
    frames, the float32 feature penalty). ``mask`` (B, S) bool."""
    with span("audio.frontend", timed=True):
        feats = conv_features(params, wave, cfg)
        if feats.shape[:2] != mask.shape:
            raise ValueError(f"{wave.shape[1]} samples make {feats.shape[1]} frames; "
                             f"the mask has {mask.shape[1]}")
        penalty = feats.float().square().mean()
        dt = feats.dtype
        x = layernorm(params["feat_norm"], feats, cfg.rmsnorm_eps)
        x = x @ params["proj"]["w"].to(dt) + params["proj"]["b"].to(dt)
        x = torch.where(mask[..., None], params["mask_emb"].to(dt), x)
    return x, penalty


def pos_conv_weight(params: dict) -> torch.Tensor:
    """w = g v / ||v||, the norm over dims 0 and 1 (``weight_norm(dim=2)``), in float32."""
    v = params["v"].float()
    return params["g"].float() * v / torch.linalg.vector_norm(v, dim=(0, 1), keepdim=True)


def pos_conv(params: dict, x: torch.Tensor, cfg: ConvAudioConfig) -> torch.Tensor:
    """x + GELU(grouped conv over positions), the last output frame dropped
    for an even kernel. x (B, S, D)."""
    with span("audio.posconv", timed=True):
        p = params["pos_conv"]
        w = pos_conv_weight(p).to(x.dtype)
        K = w.shape[-1]
        # oneDNN's bfloat16 grouped conv (the CPU's, v3.12) returns wrong
        # sums below 16 channels a group; the flag leaves CUDA untouched.
        with torch.backends.mkldnn.flags(enabled=False):
            y = F.conv1d(x.transpose(1, 2), w, p["b"].to(x.dtype), padding=K // 2,
                         groups=cfg.num_conv_pos_embedding_groups)
        if K % 2 == 0:
            y = y[..., :-1]
        return x + F.gelu(y).transpose(1, 2)


def head_loss(params: dict, h: torch.Tensor, labels: torch.Tensor, mask: torch.Tensor,
              penalty: torch.Tensor, cfg: ConvAudioConfig) -> torch.Tensor:
    """The float32 loss: the mean cross-entropy of the cosine logits at the
    masked frames, plus ``feature_penalty`` x ``penalty``. Every frame's
    logits are formed and the unmasked weighed by 0, so that no count of
    masked frames is read to the host."""
    with span("audio.head", timed=True):
        dt = h.dtype
        proj = h @ params["proj"]["w"].to(dt) + params["proj"]["b"].to(dt)
        unit = F.normalize(proj.float(), dim=-1, eps=1e-8)
        embs = F.normalize(params["label_embs"].float(), dim=-1, eps=1e-8)
        logits = (unit @ embs.T) / cfg.logit_temp
        nll = torch.logsumexp(logits, dim=-1) - torch.gather(
            logits, -1, labels[..., None].long())[..., 0]
        weight = mask.float()
        return (nll * weight).sum() / weight.sum() + cfg.feature_penalty * penalty
