"""Flash attention with a FlashAttention-2 backward, as a ``torch.autograd.Function``.

PyTorch counterpart of ``repro.models.flash`` (a ``jax.custom_vjp``).
Forward: ``kernels.ops.flash_attention_fwd(..., return_lse=True)``, which on
the card is the hand-written kernel ``csrc/flash_attn.cu`` and on the CPU
its plain version; only (q, k, v, out, lse) are saved, O(S) beside the
inputs. Backward: the JAX package's ``_bwd_impl``, the textbook
FlashAttention-2 recomputation: per (q-block, kv-block) pair rebuild the
probability tile from lse, form ``ds = p * (dp - delta)``, and accumulate dq
per q-block and dk, dv across q-blocks. No S^2 matrix is ever built. In the
JAX package that backward is jnp, not a Pallas kernel; here it is plain
PyTorch on both devices. Causal kv-blocks wholly above a q-block's last row
are skipped: their probabilities are exactly 0, so the sums are unchanged.
The scores are recomputed in float32 from the inputs, as the kernel forms
them (its products accumulate in float32), so that ``exp(s - lse)`` uses the
scores lse was taken of; JAX's jnp einsum rounds bfloat16 scores to
bfloat16 there, which at scores of magnitude 10 already moves p by ~3 %.

When no gradient is wanted (prefill, the train step's monitored loss), the
forward is the kernel without the log-sum-exp, as serving always ran it.

Windows: the forward is the kernel with its window (query i sees key j only
if ``i - j < window``). The backward masks by the window and skips the
kv-blocks wholly below each q-block's window, so windowed layers cost
O(S * W). Its blocks are aligned to the sequence, not to the window as in
``_bwd_impl``'s (window + bq) key slice; the masked sums are the same. A
window that is not causal is one-sided, as the mask says
(``repro.models.flash._mask``): every key after the query passes it. JAX's
windowed slice ends at the q-block's last row and so drops those keys,
making its result depend on ``block_q`` (ROADMAP C8); the port takes every
key after the window's lower edge, with the mask, like JAX's
``attend_blocked(..., exploit_window=False)``.

Softcap: the forward is the kernel with its cap (each score s becomes
``softcap * tanh(s / softcap)`` before the mask); the backward rebuilds the
capped scores, takes ``p = exp(s_capped - lse)`` and carries ``ds`` back
through the cap, ``ds * (1 - (s_capped / softcap)^2)``, as the JAX
package's ``_dscores`` does.

``FlashSpec.exploit_window`` False is the JAX package's baseline of that
name: the forward is the kernel's full-range launch (every tile up to the
diagonal loaded, the window left to the mask) and the backward visits
every kv-block from the first, masking; the result is the same function.

GQA layout throughout: q (B, S, KV, G, hd) pre-scaled; k, v (B, S, KV, hd).
"""

from __future__ import annotations

from typing import NamedTuple

import torch
import torch.nn.functional as F

from repro_torch.kernels import ops
from repro_torch.kernels.ref import NEG_INF


class FlashSpec(NamedTuple):
    causal: bool
    window: int | None
    block_q: int
    block_k: int
    softcap: float | None
    exploit_window: bool = True  # False: every key block from the first, masked


def _pad_seq(x: torch.Tensor, length: int, value: float = 0.0) -> torch.Tensor:
    """Pad dim 1 of ``x`` to ``length`` with ``value``."""
    extra = length - x.shape[1]
    if extra == 0:
        return x
    pad = [0, 0] * (x.dim() - 2) + [0, extra]
    return F.pad(x, pad, value=value)


def flash_backward(q, k, v, out, lse, dout, spec: FlashSpec):
    """(dq, dk, dv) of the attention at (q, k, v) for the cotangent ``dout``.

    ``out`` and ``lse`` (B, KV, G, S) are the forward's; the port of the JAX
    package's ``_bwd_impl``. Blocks wholly above the diagonal or (with
    ``exploit_window``) wholly below a q-block's window are skipped: their
    probabilities are exactly 0, so the sums are unchanged.
    """
    B, S, KV, G, hd = q.shape
    bq, bk = min(spec.block_q, S), min(spec.block_k, S)
    nq, nk = -(-S // bq), -(-S // bk)
    Sq, Lk = nq * bq, nk * bk
    window, cap = spec.window, spec.softcap
    qp = _pad_seq(q, Sq)
    doutp = _pad_seq(dout, Sq).float()
    outp = _pad_seq(out, Sq).float()
    lse = F.pad(lse, (0, Sq - S), value=1.0)
    k_src, v_src = _pad_seq(k, Lk), _pad_seq(v, Lk)
    # delta_i = sum_h dout_i * out_i (FlashAttention-2, eq. for dS).
    delta = torch.einsum("bskgh,bskgh->bkgs", doutp, outp)
    dq = torch.zeros((B, Sq, KV, G, hd), dtype=torch.float32, device=q.device)
    dk = torch.zeros((B, Lk, KV, hd), dtype=torch.float32, device=q.device)
    dv = torch.zeros_like(dk)
    kpos_all = torch.arange(Lk, device=q.device)
    for qi in range(nq):
        rows = slice(qi * bq, (qi + 1) * bq)
        qbf = qp[:, rows].permute(0, 2, 3, 1, 4).float()  # (B, KV, G, bq, hd)
        dob = doutp[:, rows].permute(0, 2, 3, 1, 4)
        dlt, lseb = delta[..., rows], lse[..., rows]
        qpos = torch.arange(qi * bq, (qi + 1) * bq, device=q.device)
        dq_acc = torch.zeros((B, KV, G, bq, hd), dtype=torch.float32, device=q.device)
        last = nk if not spec.causal else min(nk, ((qi + 1) * bq - 1) // bk + 1)
        first = (0 if window is None or not spec.exploit_window
                 else max(0, qi * bq - window + 1) // bk)
        for j in range(first, last):
            cols = slice(j * bk, (j + 1) * bk)
            kb = k_src[:, cols].permute(0, 2, 1, 3)  # (B, KV, bk, hd)
            vbf = v_src[:, cols].permute(0, 2, 1, 3).float()
            kpos = kpos_all[cols]
            msk = kpos[None, :] < S
            if spec.causal:
                msk = msk & (kpos[None, :] <= qpos[:, None])
            if window is not None:
                msk = msk & (qpos[:, None] - kpos[None, :] < window)
            s = torch.einsum("bkgqh,bkch->bkgqc", qbf, kb.float())
            if cap is not None:
                s = cap * torch.tanh(s / cap)
            p = torch.exp(torch.where(msk, s, NEG_INF) - lseb[..., None])  # (B, KV, G, bq, bk)
            dp = torch.einsum("bkgqh,bkch->bkgqc", dob, vbf)
            ds = p * (dp - dlt[..., None])
            if cap is not None:  # through s_capped = cap * tanh(s / cap)
                ds = ds * (1.0 - torch.square(s / cap))
            ds = torch.where(msk, ds, 0.0)
            dq_acc += torch.einsum("bkgqc,bkch->bkgqh", ds, kb.float())
            dk[:, cols] += torch.einsum("bkgqc,bkgqh->bkch", ds, qbf).transpose(1, 2)
            dv[:, cols] += torch.einsum("bkgqc,bkgqh->bkch", p, dob).transpose(1, 2)
        dq[:, rows] = dq_acc.permute(0, 3, 1, 2, 4)
    return dq[:, :S].to(q.dtype), dk[:, :S].to(k.dtype), dv[:, :S].to(v.dtype)


def _kernel_args(spec: FlashSpec) -> dict:
    return dict(causal=spec.causal, sm_scale=1.0, window=spec.window, softcap=spec.softcap,
                exploit_window=spec.exploit_window)


class _FlashAttention(torch.autograd.Function):
    @staticmethod
    def forward(ctx, q, k, v, spec: FlashSpec):
        out, lse = ops.flash_attention_fwd(q, k, v, return_lse=True, **_kernel_args(spec))
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.spec = spec
        return out

    @staticmethod
    def backward(ctx, dout):
        q, k, v, out, lse = ctx.saved_tensors
        dq, dk, dv = flash_backward(q, k, v, out, lse, dout, ctx.spec)
        return dq, dk, dv, None


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    spec: FlashSpec) -> torch.Tensor:
    """q (B,S,KV,G,hd) pre-scaled; k, v (B,S,KV,hd) -> (B,S,KV,G,hd).

    Differentiable in q, k and v. Inputs must be contiguous (the kernel's rule).
    """
    if torch.is_grad_enabled() and (q.requires_grad or k.requires_grad or v.requires_grad):
        return _FlashAttention.apply(q, k, v, spec)
    return ops.flash_attention_fwd(q, k, v, **_kernel_args(spec))
