"""A held-experts MoE decoder's weights made on the device from a seed.

The tree is the one the port's ``HeldExpertsConfig`` model takes (nested
dicts, periods stacked on a leading axis): ``embed.table (V, D)`` and
``lm_head.out (D, V)`` over this card's vocabulary slice, per layer
``norm1.scale``, ``attn.{wq, wk, wv, wo}``, ``attn.{q_norm, k_norm}.scale
(hd,)``, ``norm2.scale``, ``moe.router (D, E_total)`` (float32: the whole
router) and ``moe.{gate, up} (E, D, F)``, ``moe.down (E, F, D)`` of the E
experts held here, then ``final_norm.scale``. Leaves are drawn as
``inputs/weights.py`` draws them: sorted path order, one generator, std
1/sqrt(fan_in) for matrices, 1 for the embedding, norm scales 1.
:func:`leaves` yields them one at a time in the same order and values.
"""

from __future__ import annotations

from perfbench.inputs.weights import _draw, nest


def held(config: dict) -> tuple[int, int, int]:
    """(experts held, first held id, vocabulary ids held) of this card's share."""
    E, ep = config["num_experts"], config["expert_parallel"]
    V, vp = config["vocab_size"], config["vocab_parallel"]
    if E % ep or V % vp or not 0 <= config["expert_shard"] < ep:
        raise ValueError(f"{E} experts over {ep} chips or {V} ids over {vp} do not divide")
    return E // ep, config["expert_shard"] * (E // ep), V // vp


def shapes(config: dict) -> dict:
    """dotted path -> (shape, dtype name) of every leaf."""
    D, F = config["hidden_size"], config["moe_intermediate_size"]
    H, KV = config["num_attention_heads"], config["num_key_value_heads"]
    hd, L = config["head_dim"], config["num_hidden_layers"]
    E, _, V = held(config)
    w, f32 = config["torch_dtype"], "float32"
    out = {"embed.table": ((V, D), w), "final_norm.scale": ((D,), f32),
           "lm_head.out": ((D, V), w)}
    stage = {"norm1.scale": ((D,), f32), "norm2.scale": ((D,), f32),
             "attn.wq": ((D, H * hd), w), "attn.wk": ((D, KV * hd), w),
             "attn.wv": ((D, KV * hd), w), "attn.wo": ((H * hd, D), w),
             "attn.q_norm.scale": ((hd,), f32), "attn.k_norm.scale": ((hd,), f32),
             "moe.router": ((D, config["num_experts"]), f32),
             "moe.gate": ((E, D, F), w), "moe.up": ((E, D, F), w), "moe.down": ((E, F, D), w)}
    for path, (shape, dt) in stage.items():
        out[f"stage0.pos0.{path}"] = ((L, *shape), dt)
    return out


def leaves(config: dict, seed: int, device):
    """``(path, tensor)`` in sorted path order, each drawn as :func:`make` does."""
    import torch

    g = torch.Generator(device=device)
    g.manual_seed(seed)
    for path, (shape, dt) in sorted(shapes(config).items()):
        yield path, _draw(path, shape, dt, g, device)


def make(config: dict, seed: int, device) -> dict:
    return nest(dict(leaves(config, seed, device)))
