"""The training cells' plain reference: a dense decoder, its loss, ACPD's
grouped exchange and AdamW, in float32 (TF32 off).

Plain PyTorch on the benchmark's own inputs (``inputs/weights.py``'s
weights, widened to float32, and ``inputs/tokens.py``'s batches); it imports
nothing of the program. What it computes, after the published descriptions
(Phi-3's dense decoder; Huo & Huang 2019's exchange as a gradient filter):

* the model: token embedding; per layer a pre-norm RMSNorm, q/k/v
  projections (grouped: each KV head serves H / KV consecutive query
  heads), rotary embedding on the two halves of each head (base
  ``rope_theta``), causal softmax attention with q scaled by hd^-0.5, the
  output projection, a residual add, then a pre-norm SwiGLU MLP (silu(x
  gate) * (x up)) down and a residual add; a final RMSNorm and the output
  head; the mean next-token negative log-likelihood;
* the exchange: the batch's rows split into G groups; group g's gradient
  plus its residual, dw, is filtered to the entries at or above a
  threshold near the rho-th largest |dw| (the two-round, 64-bucket
  logarithmic histogram search, copied below); groups in the round-robin
  B-of-G schedule send, every T-th step all groups send everything; the
  update is gamma times the sum of what was sent over the number sending;
  what a sending group did not send, and all a resting group had, stays as
  its residual; bytes are 8 a kept entry (4 at a dense step);
* AdamW with global-norm clipping and a warm-up then cosine learning rate,
  each new parameter kept in the type the configuration stores it in
  (bfloat16 matrices, float32 norm scales).

``precision="fp8"`` puts every matrix product, forward and backward, in
float8 e4m3 (:mod:`.numerics`): the control.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from perfbench.inputs import weights as weights_lib
from perfbench.inputs.tokens import TokenStream
from perfbench.reference.numerics import ieee_float32, matmul

NUM_BUCKETS = 64
FLOOR = 2.0**-22


def _mm(a, b, precision):
    """``a (..., k) @ b (k, m)`` through :func:`matmul` on 2-D operands."""
    out = matmul(a.reshape(-1, a.shape[-1]), b, precision)
    return out.reshape(*a.shape[:-1], b.shape[-1])


def _rmsnorm(x, scale, eps):
    return x * torch.rsqrt(torch.mean(x * x, dim=-1, keepdim=True) + eps) * scale


def _rope(x, theta):
    """x (B, S, heads, hd), positions 0..S-1."""
    S, hd = x.shape[1], x.shape[-1]
    half = hd // 2
    freqs = theta ** (-torch.arange(half, dtype=torch.float32, device=x.device) / half)
    ang = torch.arange(S, dtype=torch.float32, device=x.device)[:, None] * freqs
    cos, sin = torch.cos(ang)[None, :, None, :], torch.sin(ang)[None, :, None, :]
    x1, x2 = x[..., :half], x[..., half:]
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)


def loss(P: dict, tokens, labels, config: dict, precision: str = "float32"):
    """Mean next-token NLL of ``tokens`` (B, S) against ``labels``."""
    B, S = tokens.shape
    H, KV, hd = (config["num_attention_heads"], config["num_key_value_heads"],
                 config["head_dim"])
    eps, theta = config["rms_norm_eps"], config["rope_theta"]
    st = "stage0.pos0."
    x = P["embed.table"][tokens]
    causal = torch.ones((S, S), dtype=torch.bool, device=tokens.device).tril()
    for layer in range(config["num_hidden_layers"]):
        def w(name):
            return P[st + name][layer]

        h = _rmsnorm(x, w("norm1.scale"), eps)
        q = _rope(_mm(h, w("attn.wq"), precision).reshape(B, S, H, hd), theta) * hd**-0.5
        k = _rope(_mm(h, w("attn.wk"), precision).reshape(B, S, KV, hd), theta)
        v = _mm(h, w("attn.wv"), precision).reshape(B, S, KV, hd)
        rep = H // KV
        q = q.transpose(1, 2)
        k = k.repeat_interleave(rep, dim=2).transpose(1, 2)
        v = v.repeat_interleave(rep, dim=2).transpose(1, 2)
        s = matmul(q, k.transpose(-1, -2), precision).masked_fill(~causal, -math.inf)
        o = matmul(torch.softmax(s, dim=-1), v, precision)
        x = x + _mm(o.transpose(1, 2).reshape(B, S, H * hd), w("attn.wo"), precision)
        h = _rmsnorm(x, w("norm2.scale"), eps)
        g = F.silu(_mm(h, w("mlp.gate"), precision)) * _mm(h, w("mlp.up"), precision)
        x = x + _mm(g, w("mlp.down"), precision)
    h = _rmsnorm(x, P["final_norm.scale"], eps)
    logits = _mm(h, P["lm_head.out"], precision)
    nll = torch.logsumexp(logits, dim=-1) - torch.gather(logits, -1, labels[..., None])[..., 0]
    return nll.mean()


def _hist_round(mag, hi, lo, k):
    hi = torch.clamp(hi, min=1e-37)
    lo = torch.minimum(torch.maximum(lo, hi * 1e-37), hi)
    ratio = torch.log(lo / hi) / (NUM_BUCKETS - 1)
    idx = torch.where(mag >= lo, torch.log(torch.clamp(mag, min=1e-37) / hi) / ratio,
                      torch.full_like(mag, float(NUM_BUCKETS)))
    idx = idx.to(torch.int32).clamp(0, NUM_BUCKETS)
    counts = torch.bincount(idx.flatten().long(), minlength=NUM_BUCKETS + 1)
    reached = torch.cumsum(counts[:NUM_BUCKETS], 0) >= k
    j = torch.where(reached.any(), torch.argmax(reached.to(torch.int32)),
                    torch.tensor(NUM_BUCKETS - 1, device=mag.device))

    def edge(i):
        return hi * torch.exp(ratio * i.to(torch.float32))

    return edge(j + 1), torch.where(j > 0, edge(j), torch.full_like(hi, math.inf))


def threshold(x, k: int, refine: bool = True):
    """A threshold t with at least min(k, #{|x| >= max|x| 2^-22}) entries
    of |x| at or above it, overshooting by at most one bucket."""
    mag = torch.abs(x)
    hi = torch.max(mag)
    t_lo, t_hi = _hist_round(mag, hi, hi * FLOOR, k)
    if refine:
        t_lo, _ = _hist_round(mag, torch.where(torch.isinf(t_hi), hi, t_hi), t_lo, k)
    return t_lo


def lr_at(opt: dict, step: int) -> float:
    warm = min(step / max(opt["warmup_steps"], 1), 1.0)
    frac = min(max((step - opt["warmup_steps"])
                   / max(opt["total_steps"] - opt["warmup_steps"], 1), 0.0), 1.0)
    return opt["learning_rate"] * warm * 0.5 * (1.0 + math.cos(math.pi * frac))


def _norm(t) -> float:
    return float(torch.linalg.vector_norm(t.double()))


def train(config: dict, traffic: dict, weight_seed: int, token_seed: int, device,
          steps: int = 3, precision: str = "float32", judges=(),
          keep_values: bool = False) -> dict:
    """``steps`` steps from the seeds' weights and batches. Returns the
    numbers the check compares: ``loss`` and ``bytes`` a step, and per leaf
    ``grad`` (the first update's norm as AdamW takes it, clipped),
    ``change`` (the parameters' change after the traffic's
    ``steady_steps``, by default all ``steps``, which ``steady`` gives) and
    ``residual`` (the exchange's residuals after them); and ``values``, on the host, per
    leaf after the first step: the last group's residual where the step
    exchanges (that group rests at the first step, so it is its raw
    gradient), the clipped update otherwise. ``judges`` are such host
    copies from elsewhere: ``grad_dist[j]`` holds judge j's L2 distance from
    this run's, per leaf, and ``grad_ref`` this run's norms; ``values``
    themselves are returned with ``keep_values``."""
    shapes = weights_lib.shapes(config)
    paths = sorted(shapes)
    # The configuration stores each leaf in its type: the update is computed
    # in float32 and the new value kept in the leaf's type.
    stored = {p: getattr(torch, shapes[p][1]) for p in paths}
    P = {p: t.float() for p, t in weights_lib.leaves(config, weight_seed, device)}
    stream = TokenStream(config["vocab_size"], traffic["batch"], traffic["seq"],
                         traffic["token_zipf"], token_seed, device)
    opt, ex = traffic["optimizer"], traffic.get("exchange")
    m = {p: torch.zeros_like(P[p]) for p in paths}
    v = {p: torch.zeros_like(P[p]) for p in paths}
    G = ex["num_groups"] if ex else 1
    res = {p: torch.zeros((G, *P[p].shape), device=device) for p in paths} if ex else None
    out = {"loss": [], "bytes": [], "values": {}, "grad_ref": [],
           "grad_dist": [[] for _ in judges]}
    first = {}
    out["steady"] = steady = traffic.get("steady_steps", steps)

    def judge(p, mine):
        """Each judge's distance from ``mine`` at leaf ``p``, on the device."""
        out["grad_ref"].append(_norm(mine))
        for j, theirs in enumerate(judges):
            out["grad_dist"][j].append(_norm(theirs[p].to(mine.device).float() - mine))
        if keep_values:
            out["values"][p] = mine.to("cpu", copy=True)

    def grads_of(tok, lab):
        live = {p: P[p].detach().requires_grad_(True) for p in paths}
        with torch.enable_grad(), ieee_float32():
            value = loss(live, tok, lab, config, precision)
            gs = torch.autograd.grad(value, [live[p] for p in paths])
        return float(value.detach()), dict(zip(paths, gs))

    for s in range(steps):
        batch = stream.next_batch()
        tok, lab = batch["tokens"], batch["labels"]
        if ex is None:
            value, update = grads_of(tok, lab)
        else:
            with torch.no_grad(), ieee_float32():
                value = float(loss(P, tok, lab, config, precision))
            Gn, Bn, T = ex["num_groups"], ex["group_size"], ex["sync_period"]
            dense = s % T == T - 1
            send = [1.0 if dense or (g - s * Bn) % Gn < Bn else 0.0 for g in range(Gn)]
            denom = max(sum(send), 1.0)
            acc = {p: torch.zeros_like(P[p]) for p in paths}
            nbytes = 0.0
            rows = tok.shape[0] // Gn
            for g in range(Gn):
                _, gr = grads_of(tok[g * rows:(g + 1) * rows], lab[g * rows:(g + 1) * rows])
                for p in paths:
                    dw = res[p][g] + gr.pop(p)
                    if ex["rho"] >= 1.0 or dw.numel() < ex["min_leaf_size"]:
                        sent, kept, per = dw, dw.numel(), 4
                    elif dense:
                        sent, kept, per = dw, dw.numel(), 4
                    else:
                        keep = torch.abs(dw) >= threshold(
                            dw, max(1, int(ex["rho"] * dw.numel())), ex["refine"])
                        sent = torch.where(keep, dw, torch.zeros_like(dw))
                        kept, per = int(keep.sum()), 8
                    acc[p] += send[g] * sent
                    res[p][g] = dw - sent if send[g] > 0 else dw
                    nbytes += send[g] * kept * per
                    del dw, sent
            update = {p: ex["gamma"] * acc[p] / denom for p in paths}
            del acc
            out["bytes"].append(nbytes)
            if s == 0:
                for p in paths:
                    judge(p, res[p][Gn - 1])
        out["loss"].append(value)
        gnorm = math.sqrt(sum(float(torch.sum(update[p].double() ** 2)) for p in paths))
        scale = min(opt["grad_clip"] / max(gnorm, 1e-12), 1.0)
        t = s + 1
        lr = lr_at(opt, t)
        b1, b2 = opt["beta1"], opt["beta2"]
        c1, c2 = 1 - b1**t, 1 - b2**t
        with torch.no_grad():
            for p in paths:
                g = update.pop(p) * scale
                if s == 0:
                    first[p] = _norm(g)
                    if ex is None:
                        judge(p, g)
                m[p].mul_(b1).add_((1 - b1) * g)
                v[p].mul_(b2).add_((1 - b2) * g * g)
                delta = (m[p] / c1) / (torch.sqrt(v[p] / c2) + opt["eps"]) + opt["weight_decay"] * P[p]
                P[p] = (P[p] - lr * delta).to(stored[p]).float()
                del g, delta
        if t == steady:
            out["change"] = [_norm(P[p] - p0.float())
                             for p, p0 in weights_lib.leaves(config, weight_seed, device)]
            out["residual"] = [_norm(res[p]) for p in paths] if ex else None
    out["grad"] = [first[p] for p in paths]
    del m, v
    out["paths"] = paths
    return out
