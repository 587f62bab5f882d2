"""flash_attn.roofline (%): the flash forward's least time over its device time.

Counted work: the attention forward passes that a step's semantics need,
over the whole batch: one for the gradient, and one more for the monitored
loss where the step exchanges (``attention_forward_flops``); remat's
recomputed forwards are not counted. Each pass is q k^T and p v over the
(query, key) pairs that the causal mask keeps, 4 hd operations a pair and
head, at the card's bf16 peak. The device time is every launch of the
flash kernel in the traced window.
"""


def passes(traffic: dict) -> int:
    return 2 if traffic.get("exchange") else 1


def attention_forward_flops(config: dict, traffic: dict) -> float:
    """One causal forward over the whole batch, all layers."""
    S, B = traffic["seq"], traffic["batch"]
    pairs = S * (S + 1) // 2
    heads, hd = config["num_attention_heads"], config["head_dim"]
    return 4.0 * B * heads * hd * pairs * config["num_hidden_layers"]


def read(ctx):
    t = ctx.kernel_seconds("flash_fwd")
    if t <= 0 or ctx.units == 0:
        return None
    flops = passes(ctx.traffic) * attention_forward_flops(ctx.config, ctx.traffic)
    return 100.0 * ctx.units * flops / ctx.peaks["bfloat16_flops"] / t
