"""encoder.mfu (%): model FLOPs of the traced HuBERT steps over (window x
bf16 peak).

Model FLOPs of a step (``step_flops``), forward and backward (3 passes, 2
FLOPs a multiply-add): 6 x the block stack's matrix parameters, the
feature projection's and ``final_proj``'s, times the frames; 6 x the
multiply-adds of the conv feature encoder and of the grouped positional
conv; 3 x the bidirectional attention's score and value products (4 hd
operations a (query, key) pair and head, all S^2 pairs); 6 x the cosine
logits' products at the masked frames (their expected number,
``inputs/audio.py``). Not counted: the monitored forward of an exchanging
step and remat's recompute, as ``train.mfu`` leaves them out. The window is
the traced window's host seconds.
"""

from perfbench.inputs.audio import expected_masked_frames
from perfbench.inputs.hubert_weights import samples


def matrix_params(config: dict) -> float:
    D, F = config["hidden_size"], config["intermediate_size"]
    H, KV, hd = (config["num_attention_heads"], config["num_key_value_heads"],
                 config["head_dim"])
    per_layer = D * H * hd + 2 * D * KV * hd + H * hd * D + 2 * D * F
    return float(config["num_hidden_layers"] * per_layer + config["conv_dim"][-1] * D
                 + D * config["final_dim"])


def conv_macs(config: dict, seq: int) -> float:
    """Multiply-adds of one crop's conv encoder and positional conv."""
    n, c_in, macs = samples(config, seq), 1, 0
    for c, k, s in zip(config["conv_dim"], config["conv_kernel"], config["conv_stride"]):
        n = (n - k) // s + 1
        macs += c * c_in * k * n
        c_in = c
    D = config["hidden_size"]
    return float(macs + D * D // config["num_conv_pos_embedding_groups"]
                 * config["num_conv_pos_embeddings"] * seq)


def attention_flops(config: dict, traffic: dict) -> float:
    """One bidirectional attention forward over the batch, all layers."""
    S, B = traffic["seq"], traffic["batch"]
    return (4.0 * B * config["num_attention_heads"] * config["head_dim"] * S * S
            * config["num_hidden_layers"])


def step_flops(config: dict, traffic: dict) -> float:
    S, B = traffic["seq"], traffic["batch"]
    masked = B * expected_masked_frames(S, traffic["mask_prob"], traffic["mask_length"])
    return (6.0 * matrix_params(config) * B * S + 6.0 * conv_macs(config, S) * B
            + 3.0 * attention_flops(config, traffic)
            + 6.0 * config["final_dim"] * config["vocab_size"] * masked)


def read(ctx):
    if ctx.units == 0 or ctx.busy_s <= 0:
        return None
    return (100.0 * ctx.units * step_flops(ctx.config, ctx.traffic)
            / (ctx.window_s * ctx.peaks["bfloat16_flops"]))
