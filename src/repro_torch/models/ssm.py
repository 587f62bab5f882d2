"""Mamba2 (SSD, state-space duality) layer: chunked prefill and one-step decode.

PyTorch counterpart of ``repro.models.ssm`` (arXiv:2405.21060): per head h
with scalar decay ``a_t = exp(dt_t * A_h)`` and state ``h_t = a_t h_{t-1} +
(dt_t x_t) B_t^T`` (head_dim x N), output ``y_t = C_t h_t + D_h x_t``, gated
``RMSNorm(y * silu(z))``, out-projection.

Prefill and training use the chunked SSD form: within a chunk of Q steps

    scores[t, s] = (C_t . B_s) * exp(L_t - L_s) * dt_s,   s <= t,
    L_t = cumsum(log a)_t  (inclusive),

and the (B, H, P, N) state carries from chunk to chunk. Where the JAX
package scans over the chunks, the port loops over them in Python. Decode
is the one-step recurrence on (conv window, state), written into the cache
in place. The dtypes are the JAX package's: the depthwise conv multiplies
the compute-dtype input by the float32 weights, so everything after it runs
in float32 until ``y`` is cast back to the input's dtype before the gate.
"""

from __future__ import annotations

from typing import NamedTuple

import torch
import torch.nn.functional as F

from repro_torch.models.config import ModelConfig
from repro_torch.models.layers import rmsnorm
from repro_torch.models.param import ParamSpec


class SsmCache(NamedTuple):
    conv: torch.Tensor  # (B, W-1, conv_channels) the last raw conv inputs
    state: torch.Tensor  # (B, H, P, N) float32 SSD state


def _conv_channels(cfg: ModelConfig) -> int:
    return cfg.d_inner + 2 * cfg.ssm_state


def ssm_spec(cfg: ModelConfig) -> dict:
    D, DI, N, H = cfg.d_model, cfg.d_inner, cfg.ssm_state, cfg.ssm_heads
    W, CC = cfg.ssm_conv_width, _conv_channels(cfg)
    dt = cfg.pdtype
    f32 = torch.float32
    return {
        "wz": ParamSpec((D, DI), dt, ("embed", "ssm_inner")),
        "wx": ParamSpec((D, DI), dt, ("embed", "ssm_inner")),
        "wB": ParamSpec((D, N), dt, ("embed", None)),
        "wC": ParamSpec((D, N), dt, ("embed", None)),
        "wdt": ParamSpec((D, H), dt, ("embed", "ssm_heads")),
        "dt_bias": ParamSpec((H,), f32, ("ssm_heads",), init="zeros"),
        "A_log": ParamSpec((H,), f32, ("ssm_heads",), init="zeros"),
        "D_skip": ParamSpec((H,), f32, ("ssm_heads",), init="ones"),
        "conv_w": ParamSpec((W, CC), f32, (None, None), scale=0.5),
        "conv_b": ParamSpec((CC,), f32, (None,), init="zeros"),
        "norm": {"scale": ParamSpec((DI,), f32, ("ssm_inner",), init="ones")},
        "wout": ParamSpec((DI, D), dt, ("ssm_inner", "embed")),
    }


def _causal_depthwise_conv(u: torch.Tensor, w: torch.Tensor, b: torch.Tensor,
                           init: torch.Tensor | None = None) -> torch.Tensor:
    """u (B,S,C), w (W,C) -> causal depthwise conv; ``init`` prepends history.

    The sum runs over taps i = 0..W-1 in order, starting from 0, as the JAX
    package's Python ``sum`` does; a compute-dtype ``u`` times the float32
    ``w`` gives a float32 result."""
    W, S = w.shape[0], u.shape[1]
    if init is None:
        up = F.pad(u, (0, 0, W - 1, 0))
    else:
        up = torch.cat([init.to(u.dtype), u], dim=1)
    out = sum(up[:, i:i + S] * w[i][None, None, :] for i in range(W))
    return F.silu(out + b[None, None, :].to(u.dtype))


def _softplus(x: torch.Tensor) -> torch.Tensor:
    """``log(1 + exp(x))`` as ``jax.nn.softplus`` computes it, with no switch
    to the identity above a threshold (``torch.nn.functional.softplus`` has one)."""
    return torch.logaddexp(x, torch.zeros_like(x))


def _project(params: dict, x: torch.Tensor, cfg: ModelConfig):
    """Returns z (B,S,DI), conv input u (B,S,CC), dt (B,S,H) float32."""
    dt_ = x.dtype
    z = x @ params["wz"].to(dt_)
    xin = x @ params["wx"].to(dt_)
    Bp = x @ params["wB"].to(dt_)
    Cp = x @ params["wC"].to(dt_)
    dt_raw = x @ params["wdt"].to(dt_)
    dt_val = _softplus(dt_raw.float() + params["dt_bias"])
    return z, torch.cat([xin, Bp, Cp], dim=-1), dt_val


def _split_conv(u: torch.Tensor, cfg: ModelConfig):
    DI, N = cfg.d_inner, cfg.ssm_state
    return u[..., :DI], u[..., DI:DI + N], u[..., DI + N:]


def _gate_out(params: dict, y: torch.Tensor, z: torch.Tensor, x: torch.Tensor,
              cfg: ModelConfig) -> torch.Tensor:
    """``y`` (B,S,H*P) in ``x``'s dtype -> gated RMSNorm and out-projection."""
    out = rmsnorm(params["norm"], y * F.silu(z), cfg.rmsnorm_eps)
    return out @ params["wout"].to(x.dtype)


def ssm_forward(params: dict, x: torch.Tensor, cfg: ModelConfig, *,
                return_cache: bool = False):
    """Chunked SSD over a full sequence. x (B,S,D) -> (B,S,D).

    ``return_cache=True`` (prefill) also returns the :class:`SsmCache`: the
    last W-1 raw conv inputs (zeros before the sequence when S < W-1) and
    the float32 state after the last step, so decode continues from S."""
    B, S, _ = x.shape
    H, P, N = cfg.ssm_heads, cfg.ssm_head_dim, cfg.ssm_state
    Q = min(cfg.ssm_chunk, S)
    nc = -(-S // Q)
    Sp = nc * Q

    z, u, dt_val = _project(params, x, cfg)
    u_conv = _causal_depthwise_conv(u, params["conv_w"], params["conv_b"])
    xs, Bs, Cs = _split_conv(u_conv, cfg)
    if Sp != S:  # padded steps have dt = 0: they neither decay nor write the state
        pad = (0, 0, 0, Sp - S)
        xs, Bs, Cs, dt_val = (F.pad(t, pad) for t in (xs, Bs, Cs, dt_val))

    A = -torch.exp(params["A_log"])  # (H,) negative decay rates
    xh = xs.reshape(B, nc, Q, H, P).float()
    Bc = Bs.reshape(B, nc, Q, N).float()
    Cc = Cs.reshape(B, nc, Q, N).float()
    dtc = dt_val.reshape(B, nc, Q, H)
    L = torch.cumsum(dtc * A, dim=2)  # inclusive cumsum of log decay within a chunk
    tri = torch.tril(torch.ones(Q, Q, dtype=torch.bool, device=x.device))

    h = torch.zeros(B, H, P, N, dtype=torch.float32, device=x.device)
    ys = []
    for c in range(nc):
        xq, Bq, Cq, dtq, Lq = xh[:, c], Bc[:, c], Cc[:, c], dtc[:, c], L[:, c]
        # Intra-chunk, quadratic within the chunk only. L_t - L_s <= 0 on the
        # valid (s <= t) triangle; the clamp keeps exp finite on the other.
        cb = torch.einsum("bqn,bsn->bqs", Cq, Bq)
        decay = torch.exp(torch.clamp(Lq[:, :, None, :] - Lq[:, None, :, :], max=0.0))
        w = torch.where(tri[None, :, :, None], decay, 0.0) * dtq[:, None, :, :]
        y_intra = torch.einsum("bqsh,bshp->bqhp", cb[..., None] * w, xq)
        # The carried state's contribution, then the state at the chunk's end.
        y_inter = torch.einsum("bqn,bhpn->bqhp", Cq, h) * torch.exp(Lq)[..., None]
        total = Lq[:, -1:, :]  # (B,1,H)
        w_state = torch.exp(total - Lq) * dtq  # (B,Q,H): decay from s to the chunk's end
        h = (torch.exp(total[:, 0])[:, :, None, None] * h
             + torch.einsum("bqhp,bqn->bhpn", xq * w_state[..., None], Bq))
        ys.append(y_intra + y_inter)

    y = torch.stack(ys, dim=1).reshape(B, Sp, H, P)[:, :S]
    y = y + params["D_skip"][None, None, :, None] * xh.reshape(B, Sp, H, P)[:, :S]
    out = _gate_out(params, y.reshape(B, S, H * P).to(x.dtype), z, x, cfg)
    if not return_cache:
        return out
    W = cfg.ssm_conv_width
    u_raw = torch.cat([u.new_zeros(B, max(0, W - 1 - S), u.shape[-1]),
                       u[:, max(0, S - (W - 1)):S]], dim=1)
    return out, SsmCache(conv=u_raw, state=h)


def ssm_init_cache(cfg: ModelConfig, batch: int, dtype: torch.dtype,
                   device: torch.device) -> SsmCache:
    H, P, N = cfg.ssm_heads, cfg.ssm_head_dim, cfg.ssm_state
    return SsmCache(
        conv=torch.zeros(batch, cfg.ssm_conv_width - 1, _conv_channels(cfg), dtype=dtype,
                         device=device),
        state=torch.zeros(batch, H, P, N, dtype=torch.float32, device=device))


def ssm_decode_step(params: dict, x: torch.Tensor, cache: SsmCache,
                    cfg: ModelConfig) -> tuple[torch.Tensor, SsmCache]:
    """One-token step. x (B,1,D) -> (y (B,1,D), cache).

    The cache's conv window and state are overwritten in place with the
    step's (the JAX package returns new arrays), and ``cache`` is returned."""
    B, S, _ = x.shape
    if S != 1:
        raise ValueError(f"decode takes one token, got {S}")
    H, P = cfg.ssm_heads, cfg.ssm_head_dim

    z, u, dt_val = _project(params, x, cfg)
    u_conv = _causal_depthwise_conv(u, params["conv_w"], params["conv_b"], init=cache.conv)
    xs, Bs, Cs = _split_conv(u_conv, cfg)

    A = -torch.exp(params["A_log"])
    dt1 = dt_val[:, 0]  # (B,H)
    a = torch.exp(dt1 * A[None, :])
    xh = xs.reshape(B, H, P).float()
    Bv, Cv = Bs[:, 0].float(), Cs[:, 0].float()  # (B,N)
    inc = (dt1[:, :, None] * xh)[..., None] * Bv[:, None, None, :]
    h_new = a[:, :, None, None] * cache.state + inc
    y = torch.einsum("bn,bhpn->bhp", Cv, h_new)
    y = y + params["D_skip"][None, :, None] * xh
    out = _gate_out(params, y.reshape(B, 1, H * P).to(x.dtype), z, x, cfg)

    cache.conv.copy_(torch.cat([cache.conv[:, 1:], u.to(cache.conv.dtype)], dim=1))
    cache.state.copy_(h_new)
    return out, cache
