"""moe_train.mfu (%): model FLOPs of the traced MoE steps over (window x
bf16 peak).

Model FLOPs of a step (``step_flops``): 6 x the matrix parameters a token
touches (``touched_params``) x the tokens, plus 3 x one causal attention
forward over the batch (4 hd operations a kept (query, key) pair and
head), forward and backward. A token touches every projection of every
layer, the whole router (D x the experts it spans), and the held experts
among its top-k: k x held / total of them on average, 3 D F each; and the
output head over the vocabulary slice (the embedding is a lookup). Not
counted: the monitored forward of an exchanging step, remat's recompute
and the choices of absent experts. The window is the traced window's host
seconds.
"""

from perfbench.inputs.moe_weights import held as _held


def touched_params(config: dict) -> float:
    D, F = config["hidden_size"], config["moe_intermediate_size"]
    H, KV, hd = (config["num_attention_heads"], config["num_key_value_heads"],
                 config["head_dim"])
    E, K = config["num_experts"], config["num_experts_per_tok"]
    held, _, vocab = _held(config)
    per_layer = 2 * D * H * hd + 2 * D * KV * hd + D * E + K * held / E * 3 * D * F
    return float(config["num_hidden_layers"] * per_layer + D * vocab)


def attention_forward_flops(config: dict, traffic: dict) -> float:
    S, B = traffic["seq"], traffic["batch"]
    pairs = S * (S + 1) // 2
    return (4.0 * B * config["num_attention_heads"] * config["head_dim"] * pairs
            * config["num_hidden_layers"])


def step_flops(config: dict, traffic: dict) -> float:
    tokens = traffic["batch"] * traffic["seq"]
    return 6.0 * touched_params(config) * tokens + 3.0 * attention_forward_flops(config, traffic)


def read(ctx):
    if ctx.units == 0 or ctx.busy_s <= 0:
        return None
    return (100.0 * ctx.units * step_flops(ctx.config, ctx.traffic)
            / (ctx.window_s * ctx.peaks["bfloat16_flops"]))
