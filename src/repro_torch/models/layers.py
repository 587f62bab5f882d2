"""Shared neural layers: norms, RoPE, SwiGLU MLP, embeddings, chunked CE.

PyTorch counterpart of ``repro.models.layers``, with the same dtype
handling: norms and RoPE compute in float32 and cast back to the input's
dtype; the matrix products run in the compute dtype; logits are float32.
The port adds the block of wav2vec 2.0 and HuBERT, which the frontend
``"audio_conv"`` selects: LayerNorm with a bias, and the GELU MLP with
biases.
"""

from __future__ import annotations

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch.models.config import ModelConfig
from repro_torch.models.param import ParamSpec


def rmsnorm_spec(dim: int, axis: str | None = None) -> dict:
    return {"scale": ParamSpec((dim,), torch.float32, (axis,), init="ones")}


def rmsnorm(params: dict, x: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    xf = x.float()
    var = torch.mean(xf * xf, dim=-1, keepdim=True)
    y = xf * torch.rsqrt(var + eps) * params["scale"].float()
    return y.to(x.dtype)


def layernorm_spec(dim: int, axis: str | None = None) -> dict:
    return {"scale": ParamSpec((dim,), torch.float32, (axis,), init="ones"),
            "bias": ParamSpec((dim,), torch.float32, (axis,), init="zeros")}


def layernorm(params: dict, x: torch.Tensor, eps: float) -> torch.Tensor:
    """LayerNorm over the last dim with scale and bias, in float32."""
    y = torch.nn.functional.layer_norm(x.float(), x.shape[-1:], params["scale"].float(),
                                       params["bias"].float(), eps)
    return y.to(x.dtype)


def norm_spec(cfg: ModelConfig, dim: int, axis: str | None = None) -> dict:
    """The block norm: LayerNorm for the ``audio_conv`` frontend, else RMSNorm."""
    if cfg.frontend == "audio_conv":
        return layernorm_spec(dim, axis)
    return rmsnorm_spec(dim, axis)


def norm(params: dict, x: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    if "bias" in params:
        return layernorm(params, x, cfg.rmsnorm_eps)
    return rmsnorm(params, x, cfg.rmsnorm_eps)


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
    if cfg.frontend == "audio_conv":
        return {"w1": ParamSpec((d, f), dt, ("embed", "ff")),
                "b1": ParamSpec((f,), dt, ("ff",), init="zeros"),
                "w2": ParamSpec((f, d), dt, ("ff", "embed")),
                "b2": ParamSpec((d,), dt, ("embed",), init="zeros")}
    return {
        "gate": ParamSpec((d, f), dt, ("embed", "ff")),
        "up": ParamSpec((d, f), dt, ("embed", "ff")),
        "down": ParamSpec((f, d), dt, ("ff", "embed")),
    }


def mlp(params: dict, x: torch.Tensor) -> torch.Tensor:
    """SwiGLU, or with ``w1`` in ``params`` the GELU MLP with biases (exact
    GELU, as ``hidden_act="gelu"`` is)."""
    dt = x.dtype
    if "w1" in params:
        h = torch.nn.functional.gelu(x @ params["w1"].to(dt) + params["b1"].to(dt))
        return h @ params["w2"].to(dt) + params["b2"].to(dt)
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


def _chunk_nll(hc: torch.Tensor, lc: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    lg = (hc @ w.to(hc.dtype)).float()
    lse = torch.logsumexp(lg, dim=-1)
    picked = torch.gather(lg, -1, lc[..., None].long())[..., 0]
    return torch.sum(lse - picked)


def chunked_cross_entropy(params: dict, h: torch.Tensor, labels: torch.Tensor,
                          cfg: ModelConfig, chunk: int = 512) -> torch.Tensor:
    """Mean NLL over (B, S) without materializing (B, S, V) logits.

    The sum runs over chunks of ``chunk`` positions (and the remainder), in
    float32 and in order, as the JAX package's scan does. Each whole chunk
    runs under ``torch.utils.checkpoint`` (JAX's per-chunk
    ``jax.checkpoint``): only its (B, chunk, D) input is kept, and its
    (B, chunk, V) logits are recomputed in the backward pass.
    """
    B, S, _ = h.shape
    chunk = min(chunk, S)
    n_chunks = S // chunk
    w = params["out"]
    total = torch.zeros((), dtype=torch.float32, device=h.device)
    for c in range(n_chunks):
        span = slice(c * chunk, (c + 1) * chunk)
        total = total + checkpoint(_chunk_nll, h[:, span], labels[:, span], w,
                                   use_reentrant=False)
    if S > n_chunks * chunk:
        total = total + _chunk_nll(h[:, n_chunks * chunk:], labels[:, n_chunks * chunk:], w)
    return total / (B * S)
