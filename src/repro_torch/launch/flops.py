"""MODEL_FLOPS: the 6*N*D (train) / 2*N*D (inference) convention.

PyTorch counterpart of ``repro.launch.flops``, over the port's
``model_spec`` tree (the JAX package's, path for path). N = *active*
parameters per token: all parameters except the input embedding table, with
MoE expert weights scaled by experts_per_token / num_experts. Attention's
O(S) per-token score and value FLOPs are not included, so the useful ratio
MODEL_FLOPS / counted FLOPs reads below 1 for long contexts, and the gap is
attention, remat and padding (``launch/dryrun.py`` records it).
"""

from __future__ import annotations

import math

from repro_torch.configs import InputShape
from repro_torch.models import model_spec
from repro_torch.models.config import ModelConfig
from repro_torch.models.param import tree_leaves_with_path


def active_params(cfg: ModelConfig) -> float:
    total = 0.0
    moe_scale = (cfg.experts_per_token / cfg.num_experts) if cfg.num_experts else 1.0
    # Sorted dotted paths are the JAX tree's leaf order, so the float sum
    # adds in the same order.
    for path, s in sorted(tree_leaves_with_path(model_spec(cfg))):
        keys = path.split(".")
        n = float(math.prod(s.shape))
        if keys[:2] == ["embed", "table"]:
            continue  # input lookup is a gather, not FLOPs
        if "moe" in keys and keys[-1] in ("gate", "up", "down"):
            n *= moe_scale
        total += n
    return total


def model_flops(cfg: ModelConfig, shape: InputShape) -> float:
    n_active = active_params(cfg)
    if shape.kind == "train":
        return 6.0 * n_active * shape.global_batch * shape.seq_len
    if shape.kind == "prefill":
        return 2.0 * n_active * shape.global_batch * shape.seq_len
    if shape.kind == "decode":
        return 2.0 * n_active * shape.global_batch  # one token per sequence
    raise ValueError(shape.kind)
