"""Architecture registry and assigned input shapes.

``get_config(arch_id)`` returns the exact assigned configuration, as
``repro.configs.get_config`` does, for every architecture of the JAX
package. ``input_specs`` (abstract JAX inputs) has no counterpart yet
(ROADMAP A7).
"""

from __future__ import annotations

import dataclasses
import importlib

from repro_torch.models.config import ModelConfig

_MODULES = {
    "qwen3-14b": "qwen3_14b",
    "phi3-medium-14b": "phi3_medium_14b",
    "codeqwen1.5-7b": "codeqwen1_5_7b",
    "qwen3-moe-30b-a3b": "qwen3_moe_30b_a3b",
    "qwen3-moe-235b-a22b": "qwen3_moe_235b_a22b",
    "mamba2-780m": "mamba2_780m",
    "jamba-1.5-large-398b": "jamba_1_5_large_398b",
    "gemma3-27b": "gemma3_27b",
    "pixtral-12b": "pixtral_12b",
    "hubert-xlarge": "hubert_xlarge",
}

# Known to the JAX package, not yet runnable here: what each waits for.
_WAITING: dict[str, str] = {}


@dataclasses.dataclass(frozen=True)
class InputShape:
    name: str
    seq_len: int
    global_batch: int
    kind: str  # "train" | "prefill" | "decode"


INPUT_SHAPES = {
    "train_4k": InputShape("train_4k", 4_096, 256, "train"),
    "prefill_32k": InputShape("prefill_32k", 32_768, 32, "prefill"),
    "decode_32k": InputShape("decode_32k", 32_768, 128, "decode"),
    "long_500k": InputShape("long_500k", 524_288, 1, "decode"),
}


def get_config(arch_id: str) -> ModelConfig:
    if arch_id in _WAITING:
        raise KeyError(f"arch {arch_id!r} is not ported yet: it waits for "
                       f"{_WAITING[arch_id]}; ported: {sorted(_MODULES)}")
    if arch_id not in _MODULES:
        raise KeyError(f"unknown arch {arch_id!r}; known: {sorted(_MODULES)}")
    mod = importlib.import_module(f"repro_torch.configs.{_MODULES[arch_id]}")
    return mod.get_config()


def shape_supported(cfg: ModelConfig, shape: InputShape) -> tuple[bool, str]:
    """(supported, reason-if-not), as the JAX package decides it."""
    if shape.kind == "decode" and not cfg.supports_decode():
        return False, "encoder-only: no autoregressive decode"
    if shape.name == "long_500k" and not cfg.supports_long_decode():
        return False, "pure full-attention stack: no sub-quadratic variant"
    return True, ""
