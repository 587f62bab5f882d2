"""HuBERT's weights made on the device from a seed.

The tree is the one the port's ``frontend="audio_conv"`` model takes
(nested dicts, the blocks stacked on a leading axis): ``frontend.conv<i>``
``{w (C_out, C_in, k), b, norm.{scale, bias}}``, ``frontend.feat_norm``,
``frontend.proj.{w, b}``, ``frontend.mask_emb (D,)``,
``frontend.pos_conv.{g (1, 1, K), v (D, D / groups, K), b}``, per block
``norm1``, ``attn.{wq, wk, wv, wo, bq, bk, bv, bo}``, ``norm2``,
``mlp.{w1, b1, w2, b2}``, then ``final_norm`` and
``head.{proj.{w, b}, label_embs (V, final_dim)}``. Leaves are drawn in
sorted path order from one generator, one call a leaf, in the stored type:
matrices and convolutions with std 1/sqrt(fan_in) (their input width times
the kernel), biases with std 0.02, ``mask_emb`` and ``label_embs`` uniform
on [0, 1) (fairseq's init), the positional conv's g at sqrt(4 (D / groups)
/ K), the norm it has under fairseq's init; norm scales 1 and biases 0 in
float32. :func:`leaves` yields them one at a time in the same order and
values, so a reader can regenerate them without holding two copies.
"""

from __future__ import annotations

import math

import torch

from perfbench.inputs.weights import nest


def samples(config: dict, frames: int) -> int:
    """The fewest samples the conv encoder turns into ``frames`` frames."""
    field, stride = 1, 1
    for k, s in zip(config["conv_kernel"], config["conv_stride"]):
        field += (k - 1) * stride
        stride *= s
    return field + stride * (frames - 1)


def shapes(config: dict) -> dict:
    """dotted path -> (shape, dtype name) of every leaf."""
    D, F, V = config["hidden_size"], config["intermediate_size"], config["vocab_size"]
    H, KV = config["num_attention_heads"], config["num_key_value_heads"]
    hd, L, E = config["head_dim"], config["num_hidden_layers"], config["final_dim"]
    K, G = config["num_conv_pos_embeddings"], config["num_conv_pos_embedding_groups"]
    w, f32 = config["torch_dtype"], "float32"
    out = {}
    c_in = 1
    for i, (c, k) in enumerate(zip(config["conv_dim"], config["conv_kernel"])):
        out[f"frontend.conv{i}.w"] = ((c, c_in, k), w)
        out[f"frontend.conv{i}.b"] = ((c,), w)
        out[f"frontend.conv{i}.norm.scale"] = ((c,), f32)
        out[f"frontend.conv{i}.norm.bias"] = ((c,), f32)
        c_in = c
    out.update({"frontend.feat_norm.scale": ((c_in,), f32),
                "frontend.feat_norm.bias": ((c_in,), f32),
                "frontend.proj.w": ((c_in, D), w), "frontend.proj.b": ((D,), w),
                "frontend.mask_emb": ((D,), w),
                "frontend.pos_conv.g": ((1, 1, K), w),
                "frontend.pos_conv.v": ((D, D // G, K), w),
                "frontend.pos_conv.b": ((D,), w),
                "final_norm.scale": ((D,), f32), "final_norm.bias": ((D,), f32),
                "head.proj.w": ((D, E), w), "head.proj.b": ((E,), w),
                "head.label_embs": ((V, E), w)})
    block = {"norm1.scale": ((D,), f32), "norm1.bias": ((D,), f32),
             "norm2.scale": ((D,), f32), "norm2.bias": ((D,), f32),
             "attn.wq": ((D, H * hd), w), "attn.wk": ((D, KV * hd), w),
             "attn.wv": ((D, KV * hd), w), "attn.wo": ((H * hd, D), w),
             "attn.bq": ((H * hd,), w), "attn.bk": ((KV * hd,), w),
             "attn.bv": ((KV * hd,), w), "attn.bo": ((D,), w),
             "mlp.w1": ((D, F), w), "mlp.b1": ((F,), w),
             "mlp.w2": ((F, D), w), "mlp.b2": ((D,), w)}
    for path, (shape, dt) in block.items():
        out[f"stage0.pos0.{path}"] = ((L, *shape), dt)
    return out


def _draw(path: str, shape: tuple, dtype: str, g: torch.Generator, device,
          config: dict) -> torch.Tensor:
    dt = getattr(torch, dtype)
    name = path.rsplit(".", 1)[-1]
    if name == "scale":
        return torch.ones(shape, dtype=dt, device=device)
    if name == "bias":  # a norm's
        return torch.zeros(shape, dtype=dt, device=device)
    if name == "g":
        per_group = config["hidden_size"] // config["num_conv_pos_embedding_groups"]
        return torch.full(shape, math.sqrt(4 * per_group / shape[-1]), dtype=dt, device=device)
    if name in ("mask_emb", "label_embs"):
        return torch.rand(shape, generator=g, device=device, dtype=dt)
    if name.startswith("b"):
        return torch.randn(shape, generator=g, device=device, dtype=dt).mul_(0.02)
    fan_in = shape[-2] * shape[-1] if name in ("w", "v") and "conv" in path else shape[-2]
    return torch.randn(shape, generator=g, device=device, dtype=dt).mul_(1 / math.sqrt(fan_in))


def leaves(config: dict, seed: int, device):
    """``(path, tensor)`` in sorted path order, each drawn as :func:`make` does."""
    g = torch.Generator(device=device)
    g.manual_seed(seed)
    for path, (shape, dt) in sorted(shapes(config).items()):
        yield path, _draw(path, shape, dt, g, device, config)


def make(config: dict, seed: int, device) -> dict:
    return nest(dict(leaves(config, seed, device)))
