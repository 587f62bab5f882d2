"""train.mfu (%): model FLOPs of the traced steps over (window x bf16 peak).

Model FLOPs of a step (``step_flops``): 6 x the matrix parameters x the
tokens (every projection, the MLP and the output head; not the embedding
gather, a lookup) plus the attention's score and value products, forward
and backward (3 x one causal forward over the batch). Not counted: the
monitored forward of an exchanging step and remat's recompute. The window
is the traced window's host seconds.
"""


def matrix_params(config: dict) -> float:
    D, F, V = config["hidden_size"], config["intermediate_size"], config["vocab_size"]
    H, KV, hd = (config["num_attention_heads"], config["num_key_value_heads"],
                 config["head_dim"])
    per_layer = D * H * hd + 2 * D * KV * hd + H * hd * D + 3 * D * F
    return float(config["num_hidden_layers"] * per_layer + D * V)


def step_flops(config: dict, traffic: dict) -> float:
    S, B = traffic["seq"], traffic["batch"]
    pairs = S * (S + 1) // 2
    attn = 4.0 * B * config["num_attention_heads"] * config["head_dim"] * pairs
    return 6.0 * matrix_params(config) * B * S + 3.0 * attn * config["num_hidden_layers"]


def read(ctx):
    if ctx.units == 0 or ctx.busy_s <= 0:
        return None
    return (100.0 * ctx.units * step_flops(ctx.config, ctx.traffic)
            / (ctx.window_s * ctx.peaks["bfloat16_flops"]))
