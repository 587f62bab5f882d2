"""encoder_attn.roofline (%): the flash forward's least time over its device
time, in the bidirectional encoder.

Counted work: every attention forward pass the kernel runs over the
whole batch in a step (``passes``): one for the gradient, one more under
``remat`` (its recompute) and one more for the monitored loss where the
step exchanges; each q k^T and p v over all S^2 (query, key) pairs: 4 hd
operations a pair and head, at the card's bf16 peak. The device time is
every launch of the flash kernel in the traced window, so the count holds
each launch's work. (``flash_attn.roofline`` counts a decoder's causal
pairs and leaves remat's recompute out.)
"""


def passes(traffic: dict) -> int:
    return 1 + bool(traffic.get("remat")) + bool(traffic.get("exchange"))


def attention_forward_flops(config: dict, traffic: dict) -> float:
    S, B = traffic["seq"], traffic["batch"]
    return (4.0 * B * config["num_attention_heads"] * config["head_dim"] * S * S
            * config["num_hidden_layers"])


def read(ctx):
    t = ctx.kernel_seconds("flash_fwd")
    if t <= 0 or ctx.units == 0:
        return None
    flops = passes(ctx.traffic) * attention_forward_flops(ctx.config, ctx.traffic)
    return 100.0 * ctx.units * flops / ctx.peaks["bfloat16_flops"] / t
