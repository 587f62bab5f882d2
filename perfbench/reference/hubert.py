"""The HuBERT cell's plain reference: HuBERT X-Large's masked-unit loss,
ACPD's grouped exchange and AdamW, in float32 (TF32 off).

Plain PyTorch on the benchmark's own inputs (``inputs/hubert_weights.py``'s
weights, widened to float32, and ``inputs/audio.py``'s batches); it imports
nothing of the program. What it computes, after the published descriptions
(HuBERT, arXiv:2106.07447, and fairseq's ``HubertModel``; the encoder of
wav2vec 2.0, arXiv:2006.11477, in its stable-layer-norm form):

* the conv feature encoder: per layer a convolution with bias over the
  samples, written as the product of the unfolded input with the kernel,
  then LayerNorm over the channels (eps 1e-5) and exact GELU;
* the feature penalty, the encoder output's mean square;
* LayerNorm over the features, the projection to the model width, and the
  masked frames replaced by ``mask_emb``;
* the positional conv: x + GELU(the grouped convolution over positions,
  padded by K / 2 on each side, its last output frame dropped), each group
  an unfolded product, its weight g v / ||v|| (the norm over the output and
  input channels of each tap);
* per layer: x + Wo attn(LN1(x)) + bo, with q/k/v biases, q scaled by
  hd^-0.5 after its bias, bidirectional softmax attention (each KV head
  serving H / KV consecutive query heads), then x + W2 GELU(W1 LN2(x) +
  b1) + b2; a final LayerNorm;
* the head: final_proj, cosine similarity with each unit embedding over
  ``logit_temp``, the mean cross-entropy over the masked frames, plus
  ``feature_penalty`` times the feature penalty;
* the exchange and AdamW as ``reference/decoder.py`` has them.

``precision="fp8"`` puts every product, forward and backward, the
convolutions' among them, in float8 e4m3 (:mod:`.numerics`): the control.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from perfbench.inputs import hubert_weights as weights_lib
from perfbench.inputs.audio import AudioStream
from perfbench.reference.decoder import _mm, _norm, lr_at, threshold
from perfbench.reference.numerics import ieee_float32, matmul

CONV_NORM_EPS = 1e-5


def _layernorm(x, scale, bias, eps):
    mean = torch.mean(x, dim=-1, keepdim=True)
    var = torch.mean(torch.square(x - mean), dim=-1, keepdim=True)
    return (x - mean) / torch.sqrt(var + eps) * scale + bias


def _conv(x, w, stride, precision):
    """x (B, T, C_in) -> (B, T_out, C_out): w (C_out, C_in, k) over the unfolded input."""
    c_out, c_in, k = w.shape
    cols = x.unfold(1, k, stride)  # (B, T_out, C_in, k)
    return _mm(cols.reshape(*cols.shape[:2], c_in * k), w.reshape(c_out, c_in * k).T, precision)


def features(P: dict, wave, config: dict, precision: str = "float32"):
    """The conv encoder's output (B, S, C) of samples (B, n)."""
    x = wave[..., None]
    for i, stride in enumerate(config["conv_stride"]):
        pre = f"frontend.conv{i}."
        x = _conv(x, P[pre + "w"], stride, precision) + P[pre + "b"]
        x = F.gelu(_layernorm(x, P[pre + "norm.scale"], P[pre + "norm.bias"], CONV_NORM_EPS))
    return x


def pos_conv(P: dict, x, config: dict, precision: str = "float32"):
    """x + GELU(grouped conv over positions), x (B, S, D)."""
    v, g = P["frontend.pos_conv.v"], P["frontend.pos_conv.g"]
    w = g * v / torch.sqrt(torch.sum(v * v, dim=(0, 1), keepdim=True))
    D, per, K = w.shape
    S = x.shape[1]
    xp = F.pad(x, (0, 0, K // 2, K // 2))
    parts = [_conv(xp[..., i * per:(i + 1) * per], w[i * per:(i + 1) * per], 1, precision)[:, :S]
             for i in range(D // per)]
    return x + F.gelu(torch.cat(parts, dim=-1) + P["frontend.pos_conv.b"])


def hidden(P: dict, wave, mask, config: dict, precision: str = "float32"):
    """(the final LayerNorm's output (B, S, D), the feature penalty)."""
    H, KV, hd = (config["num_attention_heads"], config["num_key_value_heads"],
                 config["head_dim"])
    eps = config["layer_norm_eps"]
    feats = features(P, wave, config, precision)
    penalty = torch.mean(feats * feats)
    x = _layernorm(feats, P["frontend.feat_norm.scale"], P["frontend.feat_norm.bias"], eps)
    x = _mm(x, P["frontend.proj.w"], precision) + P["frontend.proj.b"]
    x = torch.where(mask[..., None], P["frontend.mask_emb"], x)
    x = pos_conv(P, x, config, precision)
    B, S, _ = x.shape
    st = "stage0.pos0."
    for layer in range(config["num_hidden_layers"]):
        def w(name):
            return P[st + name][layer]

        h = _layernorm(x, w("norm1.scale"), w("norm1.bias"), eps)
        q = (_mm(h, w("attn.wq"), precision) + w("attn.bq")).reshape(B, S, H, hd) * hd**-0.5
        k = (_mm(h, w("attn.wk"), precision) + w("attn.bk")).reshape(B, S, KV, hd)
        v = (_mm(h, w("attn.wv"), precision) + w("attn.bv")).reshape(B, S, KV, hd)
        rep = H // KV
        q = q.transpose(1, 2)
        k = k.repeat_interleave(rep, dim=2).transpose(1, 2)
        v = v.repeat_interleave(rep, dim=2).transpose(1, 2)
        s = matmul(q, k.transpose(-1, -2), precision)
        o = matmul(torch.softmax(s, dim=-1), v, precision)
        x = x + _mm(o.transpose(1, 2).reshape(B, S, H * hd), w("attn.wo"), precision) + w("attn.bo")
        h = _layernorm(x, w("norm2.scale"), w("norm2.bias"), eps)
        h = F.gelu(_mm(h, w("mlp.w1"), precision) + w("mlp.b1"))
        x = x + _mm(h, w("mlp.w2"), precision) + w("mlp.b2")
    return _layernorm(x, P["final_norm.scale"], P["final_norm.bias"], eps), penalty


def loss(P: dict, batch: dict, config: dict, precision: str = "float32"):
    """The masked-unit loss of a batch (``waveform``, ``mask``, ``labels``)."""
    h, penalty = hidden(P, batch["waveform"], batch["mask"], config, precision)
    proj = _mm(h, P["head.proj.w"], precision) + P["head.proj.b"]
    unit = proj / torch.clamp(torch.linalg.vector_norm(proj, dim=-1, keepdim=True), min=1e-8)
    embs = P["head.label_embs"]
    embs = embs / torch.clamp(torch.linalg.vector_norm(embs, dim=-1, keepdim=True), min=1e-8)
    logits = _mm(unit, embs.T, precision) / config["logit_temp"]
    labels = batch["labels"]
    nll = torch.logsumexp(logits, dim=-1) - torch.gather(logits, -1, labels[..., None])[..., 0]
    m = batch["mask"].float()
    return torch.sum(nll * m) / torch.sum(m) + config["feature_penalty"] * penalty


def train(config: dict, traffic: dict, weight_seed: int, batch_seed: int, device,
          steps: int = 3, precision: str = "float32", judges=(),
          keep_values: bool = False) -> dict:
    """``steps`` steps from the seeds' weights and batches; returns what
    ``reference/decoder.py``'s ``train`` returns, for the same check."""
    shapes = weights_lib.shapes(config)
    paths = sorted(shapes)
    stored = {p: getattr(torch, shapes[p][1]) for p in paths}
    P = {p: t.float() for p, t in weights_lib.leaves(config, weight_seed, device)}
    stream = AudioStream(config, traffic, batch_seed, device)
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

    def grads_of(part):
        live = {p: P[p].detach().requires_grad_(True) for p in paths}
        with torch.enable_grad(), ieee_float32():
            value = loss(live, part, config, precision)
            gs = torch.autograd.grad(value, [live[p] for p in paths])
        return float(value.detach()), dict(zip(paths, gs))

    for s in range(steps):
        batch = stream.next_batch()
        if ex is None:
            value, update = grads_of(batch)
        else:
            with torch.no_grad(), ieee_float32():
                value = float(loss(P, batch, config, precision))
            Gn, Bn, T = ex["num_groups"], ex["group_size"], ex["sync_period"]
            dense = s % T == T - 1
            send = [1.0 if dense or (g - s * Bn) % Gn < Bn else 0.0 for g in range(Gn)]
            denom = max(sum(send), 1.0)
            acc = {p: torch.zeros_like(P[p]) for p in paths}
            nbytes = 0.0
            rows = batch["waveform"].shape[0] // Gn
            for g in range(Gn):
                _, gr = grads_of({k: t[g * rows:(g + 1) * rows] for k, t in batch.items()})
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
