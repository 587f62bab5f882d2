"""A dense decoder's weights made on the device from a seed.

The tree is the one the port's models take (nested dicts, periods stacked
on a leading axis): ``embed.table (V, D)``, per stage ``norm1.scale``,
``attn.{wq, wk, wv, wo}``, ``norm2.scale``, ``mlp.{gate, up, down}``,
``final_norm.scale (D,)`` and ``lm_head.out (D, V)``. Leaves are drawn in
sorted path order from one generator, one call a leaf, in the served type:
matrices with std 1/sqrt(fan_in) (their input width), the embedding with
std 1, norm scales at 1 in float32. :func:`leaves` yields them one at a
time in the same order and values, so a reader can regenerate them without
holding two copies.
"""

from __future__ import annotations

import math

import torch


def shapes(config: dict) -> dict:
    """dotted path -> (shape, dtype name) of every leaf."""
    D, F, V = config["hidden_size"], config["intermediate_size"], config["vocab_size"]
    H, KV = config["num_attention_heads"], config["num_key_value_heads"]
    hd, L = config["head_dim"], config["num_hidden_layers"]
    w = config["torch_dtype"]
    out = {"embed.table": ((V, D), w), "final_norm.scale": ((D,), "float32"),
           "lm_head.out": ((D, V), w)}
    stage = {"norm1.scale": ((D,), "float32"), "norm2.scale": ((D,), "float32"),
             "attn.wq": ((D, H * hd), w), "attn.wk": ((D, KV * hd), w),
             "attn.wv": ((D, KV * hd), w), "attn.wo": ((H * hd, D), w),
             "mlp.gate": ((D, F), w), "mlp.up": ((D, F), w), "mlp.down": ((F, D), w)}
    for path, (shape, dt) in stage.items():
        out[f"stage0.pos0.{path}"] = ((L, *shape), dt)
    return out


def _draw(path: str, shape: tuple, dtype: str, g: torch.Generator, device) -> torch.Tensor:
    dt = getattr(torch, dtype)
    if path.endswith(".scale"):
        return torch.ones(shape, dtype=dt, device=device)
    std = 1.0 if path == "embed.table" else 1.0 / math.sqrt(shape[-2])
    return torch.randn(shape, generator=g, device=device, dtype=dt).mul_(std)


def leaves(config: dict, seed: int, device):
    """``(path, tensor)`` in sorted path order, each drawn as :func:`make` does."""
    g = torch.Generator(device=device)
    g.manual_seed(seed)
    for path, (shape, dt) in sorted(shapes(config).items()):
        yield path, _draw(path, shape, dt, g, device)


def nest(flat: dict) -> dict:
    tree: dict = {}
    for path, leaf in flat.items():
        node = tree
        *head, last = path.split(".")
        for k in head:
            node = node.setdefault(k, {})
        node[last] = leaf
    return tree


def make(config: dict, seed: int, device) -> dict:
    return nest(dict(leaves(config, seed, device)))
