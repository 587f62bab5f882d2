"""The Qwen3-MoE cell's plain reference: the decoder with one chip's share of
the experts, its loss with the load-balance term, ACPD's grouped exchange
and AdamW, in float32 (TF32 off).

Plain PyTorch on the benchmark's own inputs (``inputs/moe_weights.py``'s
weights, widened to float32, and ``inputs/tokens.py``'s batches over the
vocabulary slice); it imports nothing of the program. What it computes,
after the published description (Qwen3 Technical Report, arXiv:2505.09388,
and transformers' ``Qwen3MoeForCausalLM``):

* per layer a pre-norm RMSNorm; q/k/v projections without biases (each KV
  head serving H / KV consecutive query heads); RMSNorm over each head's q
  and k (eps ``rms_norm_eps``, a scale per channel) before the rotary
  embedding on the two halves of each head (base ``rope_theta``); causal
  softmax attention with q scaled by hd^-0.5, computed a block of queries
  at a time; the output projection and a residual add;
* then a pre-norm sparse MoE: float32 router logits over all the experts
  the router spans, their softmax, the top ``num_experts_per_tok`` by
  probability renormalised over the chosen (``norm_topk_prob``); each
  (token, choice) whose expert is held here adds its weight times the
  expert's SwiGLU, down(silu(x gate) * (x up)); the other choices add
  nothing (the share's partial result); a residual add;
* a final RMSNorm, the output head over the slice, the mean next-token
  negative log-likelihood, plus ``router_aux_loss_coef`` times
  transformers' ``load_balancing_loss_func`` over all layers' router
  outputs at once: the number of experts times the sum over experts e and
  choices k of the share of rows whose k-th choice is e times e's mean
  probability;
* the exchange and AdamW as ``reference/decoder.py`` has them.

Each layer runs under ``torch.utils.checkpoint``, so that the gradient of a
4,096-token group fits beside the float32 state. ``precision="fp8"`` puts
every matrix product, forward and backward, in float8 e4m3
(:mod:`.numerics`): the control.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from perfbench.inputs import moe_weights as weights_lib
from perfbench.inputs.tokens import TokenStream
from perfbench.reference.decoder import _mm, _norm, _rmsnorm, _rope, lr_at, threshold
from perfbench.reference.numerics import ieee_float32, matmul

QUERY_BLOCK = 1024


def _attention(q, k, v, precision):
    """Causal softmax attention of q (B, H, S, hd), pre-scaled, over k, v
    (B, H, S, hd), ``QUERY_BLOCK`` queries at a time over the keys up to the
    block's last."""
    S = q.shape[2]
    outs = []
    for lo in range(0, S, QUERY_BLOCK):
        hi = min(S, lo + QUERY_BLOCK)
        s = matmul(q[:, :, lo:hi], k[:, :, :hi].transpose(-1, -2), precision)
        later = (torch.arange(hi, device=q.device)[None, :]
                 > torch.arange(lo, hi, device=q.device)[:, None])
        s = s.masked_fill(later, -math.inf)
        outs.append(matmul(torch.softmax(s, dim=-1), v[:, :, :hi], precision))
    return torch.cat(outs, dim=2)


def route(h, router, K: int, precision: str = "float32"):
    """(probs (N, E_total), top_p (N, K) renormalised, top_e (N, K)) of h (N, D)."""
    probs = torch.softmax(_mm(h, router, precision), dim=-1)
    top_p, top_e = torch.topk(probs, K, dim=-1)
    return probs, top_p / top_p.sum(-1, keepdim=True), top_e


def moe(h, W: dict, config: dict, precision: str = "float32"):
    """The held experts' part of the MoE layer for h (N, D): (out (N, D),
    stats (2, E_total): each expert's share of the top-k choices and its
    mean probability, top_e (N, K))."""
    E, first, _ = weights_lib.held(config)
    K = config["num_experts_per_tok"]
    probs, top_p, top_e = route(h, W["moe.router"], K, precision)
    out = torch.zeros_like(h)
    for j in range(E):
        tok, k = torch.nonzero(top_e == first + j, as_tuple=True)
        if tok.numel():
            x = h[tok]
            g = F.silu(_mm(x, W["moe.gate"][j], precision)) * _mm(x, W["moe.up"][j], precision)
            y = _mm(g, W["moe.down"][j], precision)
            out = out.index_add(0, tok, y * top_p[tok, k][:, None])
    chosen = F.one_hot(top_e, config["num_experts"]).float().sum(1).mean(0)
    return out, torch.stack([chosen, probs.mean(0)]), top_e


def _layer(x, W: dict, config: dict, precision: str):
    """One decoder layer: (x, stats, the MoE's top-k expert ids)."""
    B, S, D = x.shape
    H, KV, hd = (config["num_attention_heads"], config["num_key_value_heads"],
                 config["head_dim"])
    eps, theta = config["rms_norm_eps"], config["rope_theta"]
    h = _rmsnorm(x, W["norm1.scale"], eps)
    q = _mm(h, W["attn.wq"], precision).reshape(B, S, H, hd)
    k = _mm(h, W["attn.wk"], precision).reshape(B, S, KV, hd)
    v = _mm(h, W["attn.wv"], precision).reshape(B, S, KV, hd)
    q = _rope(_rmsnorm(q, W["attn.q_norm.scale"], eps), theta) * hd**-0.5
    k = _rope(_rmsnorm(k, W["attn.k_norm.scale"], eps), theta)
    rep = H // KV
    o = _attention(q.transpose(1, 2), k.repeat_interleave(rep, dim=2).transpose(1, 2),
                   v.repeat_interleave(rep, dim=2).transpose(1, 2), precision)
    x = x + _mm(o.transpose(1, 2).reshape(B, S, H * hd), W["attn.wo"], precision)
    out, stats, top_e = moe(_rmsnorm(x, W["norm2.scale"], eps).reshape(B * S, D), W, config,
                            precision)
    return x + out.reshape(B, S, D), stats, top_e


def load_balance(stats, config: dict):
    """``load_balancing_loss_func`` from the layers' summed statistics."""
    share, prob = stats / config["num_hidden_layers"]
    return config["num_experts"] * torch.sum(share * prob)


def loss(P: dict, tokens, labels, config: dict, precision: str = "float32", routes=None):
    """Mean next-token NLL of ``tokens`` (B, S) against ``labels`` plus the
    load-balance term. ``routes``, a list, receives each layer's top-k
    expert ids (B S, K) on the host."""
    x = P["embed.table"][tokens]
    stats = torch.zeros((), device=x.device)
    st = "stage0.pos0."
    for layer in range(config["num_hidden_layers"]):
        W = {n[len(st):]: t[layer] for n, t in P.items() if n.startswith(st)}
        if torch.is_grad_enabled():
            x, s, top_e = checkpoint(_layer, x, W, config, precision, use_reentrant=False)
        else:
            x, s, top_e = _layer(x, W, config, precision)
        if routes is not None:
            routes.append(top_e.cpu())
        stats = stats + s
    h = _rmsnorm(x, P["final_norm.scale"], config["rms_norm_eps"])
    logits = _mm(h, P["lm_head.out"], precision)
    nll = torch.logsumexp(logits, dim=-1) - torch.gather(logits, -1, labels[..., None])[..., 0]
    return nll.mean() + config["router_aux_loss_coef"] * load_balance(stats, config)


def flipped(a: list, b: list) -> int:
    """(token, choice) pairs of routes ``a`` whose expert is not among the
    token's choices in ``b``, over all layers; routes of other tokens (a
    batch of another size) flip every pair of ``a``."""
    return sum(int((x[:, :, None] != y[:, None, :]).all(-1).sum()) if x.shape == y.shape
               else x.numel() for x, y in zip(a, b))


def train(config: dict, traffic: dict, weight_seed: int, token_seed: int, device,
          steps: int = 3, precision: str = "float32", judges=(),
          keep_values: bool = False, routes=None) -> dict:
    """``steps`` steps from the seeds' weights and batches; returns what
    ``reference/decoder.py``'s ``train`` returns, for the same check. Given
    ``routes``, another run's top-k expert ids of each layer in the first
    step's monitored forward, ``flipped`` counts its (token, choice) pairs
    whose expert this run's routing did not choose, of ``pairs``."""
    shapes = weights_lib.shapes(config)
    paths = sorted(shapes)
    stored = {p: getattr(torch, shapes[p][1]) for p in paths}
    P = {p: t.float() for p, t in weights_lib.leaves(config, weight_seed, device)}
    stream = TokenStream(weights_lib.held(config)[2], traffic["batch"], traffic["seq"],
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
        mine = [] if s == 0 and routes is not None else None
        if ex is None:
            with torch.no_grad(), ieee_float32():
                if mine is not None:
                    loss(P, tok, lab, config, precision, routes=mine)
            value, update = grads_of(tok, lab)
        else:
            with torch.no_grad(), ieee_float32():
                value = float(loss(P, tok, lab, config, precision, routes=mine))
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
                    if ex["rho"] >= 1.0 or dw.numel() < ex["min_leaf_size"] or dense:
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
        if mine is not None:
            out["flipped"] = flipped(routes, mine)
            out["pairs"] = sum(r.numel() for r in routes)
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
