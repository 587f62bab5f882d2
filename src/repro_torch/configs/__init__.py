"""Architecture registry and assigned input shapes.

``get_config(arch_id)`` returns the exact assigned configuration, as
``repro.configs.get_config`` does, for every architecture of the JAX
package. ``input_specs(cfg, shape)`` returns stand-ins for every input of
the step that ``shape.kind`` selects: tensors on the ``meta`` device (shape
and dtype, never allocated) where the JAX package returns
``jax.ShapeDtypeStruct``s, so that even the 398 B configs exist only
abstractly. Token ids and labels are int64, PyTorch's index type (the JAX
package's are int32, as in ``data/pipeline.py``).
"""

from __future__ import annotations

import dataclasses
import importlib

import torch

from repro_torch.models import init_caches
from repro_torch.models.config import ModelConfig

_MODULES = {  # in the JAX package's order, which ARCH_IDS keeps
    "pixtral-12b": "pixtral_12b",
    "qwen3-moe-30b-a3b": "qwen3_moe_30b_a3b",
    "jamba-1.5-large-398b": "jamba_1_5_large_398b",
    "mamba2-780m": "mamba2_780m",
    "qwen3-moe-235b-a22b": "qwen3_moe_235b_a22b",
    "hubert-xlarge": "hubert_xlarge",
    "qwen3-14b": "qwen3_14b",
    "phi3-medium-14b": "phi3_medium_14b",
    "gemma3-27b": "gemma3_27b",
    "codeqwen1.5-7b": "codeqwen1_5_7b",
}

ARCH_IDS = tuple(_MODULES)

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


def _token_batch(cfg: ModelConfig, batch: int, seq: int, with_labels: bool) -> dict:
    def meta(shape, dtype):
        return torch.empty(shape, dtype=dtype, device="meta")

    ids = torch.int64
    if cfg.frontend == "text":
        out = {"tokens": meta((batch, seq), ids)}
        text = seq
    elif cfg.frontend == "vision_stub":
        p = min(cfg.num_patch_tokens, seq // 2)
        text = seq - p
        out = {"tokens": meta((batch, text), ids),
               "patch_embeds": meta((batch, p, cfg.d_model), cfg.cdtype)}
    elif cfg.frontend == "audio_stub":
        out = {"frame_embeds": meta((batch, seq, cfg.d_model), cfg.cdtype)}
        text = seq
    else:
        raise ValueError(cfg.frontend)
    if with_labels:
        out["labels"] = meta((batch, text), ids)
    return out


def input_specs(cfg: ModelConfig, shape: InputShape) -> dict:
    """Abstract inputs of the step that ``shape.kind`` selects, as ``meta``
    tensors: ``{"batch": ...}`` for train (with labels) and prefill; for
    decode ``token`` (B,), the caches of ``init_caches(cfg, B, seq_len)`` in
    the compute dtype, and ``cache_len``. The port's ``decode_step`` takes
    ``cache_len`` as a Python int, so here it is the int ``seq_len`` (a
    decode step at the last slot of a full cache) where the JAX package
    has an abstract int32 scalar. An unsupported pair raises ``ValueError``."""
    ok, why = shape_supported(cfg, shape)
    if not ok:
        raise ValueError(f"{cfg.arch_id} x {shape.name} unsupported: {why}")
    if shape.kind in ("train", "prefill"):
        return {"batch": _token_batch(cfg, shape.global_batch, shape.seq_len,
                                      shape.kind == "train")}
    if shape.kind == "decode":
        B, S = shape.global_batch, shape.seq_len
        return {"token": torch.empty((B,), dtype=torch.int64, device="meta"),
                "caches": init_caches(cfg, B, S, cfg.cdtype, "meta"),
                "cache_len": S}
    raise ValueError(shape.kind)
