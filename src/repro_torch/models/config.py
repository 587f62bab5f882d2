"""Model configuration (PyTorch counterpart of ``repro.models.config``).

A model is a sequence of *stages*; each stage is a stack of identical
*periods*; a period is a tuple of :class:`LayerSpec`s. The JAX package scans
each stage; the port loops over its periods in Python. The dataclasses and
their field values are the JAX package's; only ``pdtype``/``cdtype`` give
``torch.dtype``s.

:class:`ConvAudioConfig` is the port's own: a waveform encoder as HuBERT
and wav2vec 2.0 publish it (``frontend="audio_conv"``: conv feature
encoder, convolutional positions, pre-LN GELU blocks with biases,
masked-unit head). That frontend alone selects the block's published form
(``models/layers.py``, ``models/attention.py``), so ``ModelConfig``'s
fields stay the JAX package's and every other config runs as before.

:class:`HeldExpertsConfig` is the port's other own class: a MoE decoder of
which this card holds one expert-parallel share of the experts, routed over
all of them without a capacity (``models/moe.py``'s held-experts path), with
the published load-balance term (``models/model.py`` ``train_loss``). The
class alone selects that path; the JAX package's MoE configs keep its
capacity path.
"""

from __future__ import annotations

import dataclasses
from typing import Literal

import torch

Family = Literal["dense", "moe", "hybrid", "ssm", "audio", "vlm"]
LayerKind = Literal["attn", "mamba"]
MlpKind = Literal["dense", "moe", "none"]

_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16,
           "float16": torch.float16}


@dataclasses.dataclass(frozen=True)
class LayerSpec:
    kind: LayerKind = "attn"
    mlp: MlpKind = "dense"
    window: int | None = None  # sliding-window size; None = full attention


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    arch_id: str
    family: Family
    num_layers: int
    d_model: int
    num_heads: int
    num_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: int | None = None  # None -> d_model // num_heads

    # Attention details.
    qk_norm: bool = False
    rope_theta: float = 10_000.0
    causal: bool = True  # False for encoder-only (hubert)
    attn_logit_softcap: float | None = None

    # Layer pattern. Default: homogeneous attention stack.
    layout: tuple[LayerSpec, ...] = (LayerSpec(),)

    # MoE.
    num_experts: int = 0
    experts_per_token: int = 0
    d_ff_expert: int = 0
    moe_capacity_factor: float = 1.25
    norm_topk_probs: bool = True

    # SSM (Mamba2 / SSD).
    ssm_state: int = 0
    ssm_expand: int = 2
    ssm_head_dim: int = 64
    ssm_conv_width: int = 4
    ssm_chunk: int = 256

    # Modality frontend.
    frontend: Literal["text", "audio_stub", "vision_stub", "audio_conv"] = "text"
    num_patch_tokens: int = 1024

    # Numerics.
    param_dtype: str = "float32"
    compute_dtype: str = "bfloat16"
    rmsnorm_eps: float = 1e-6

    source: str = ""

    def __post_init__(self):
        if self.num_heads % max(self.num_kv_heads, 1) != 0:
            raise ValueError(f"num_heads {self.num_heads} is not a multiple of "
                             f"num_kv_heads {self.num_kv_heads} (GQA grouping)")

    @property
    def resolved_head_dim(self) -> int:
        return self.head_dim if self.head_dim is not None else self.d_model // self.num_heads

    @property
    def d_inner(self) -> int:
        return self.ssm_expand * self.d_model

    @property
    def ssm_heads(self) -> int:
        return self.d_inner // self.ssm_head_dim

    @property
    def pdtype(self) -> torch.dtype:
        return _DTYPES[self.param_dtype]

    @property
    def cdtype(self) -> torch.dtype:
        return _DTYPES[self.compute_dtype]

    @property
    def copies_attn_scale(self) -> bool:
        """Whether attention copies q's rounded scale to the device in every
        layer (``sync.attn_scale``, a host sync; ROADMAP G9). The JAX
        package's decoders still do; the port's own classes scale by a Python
        float, so their loss makes no host sync and ``launch/steps.py``
        graphs its gradient on the card."""
        return self.frontend != "audio_conv"

    def stages(self) -> list[tuple[tuple[LayerSpec, ...], int]]:
        """[(period_layout, num_periods), ...] covering exactly num_layers."""
        period = len(self.layout)
        full, rem = divmod(self.num_layers, period)
        out: list[tuple[tuple[LayerSpec, ...], int]] = []
        if full:
            out.append((self.layout, full))
        if rem:
            out.append((self.layout[:rem], 1))
        return out

    def has_attention(self) -> bool:
        return any(l.kind == "attn" for l in self.layout)

    def max_window(self) -> int | None:
        """None if any attention layer is full/global (unbounded context cost)."""
        windows = [l.window for l in self.layout if l.kind == "attn"]
        if not windows:
            return 0
        if any(w is None for w in windows):
            return None
        return max(windows)

    def supports_long_decode(self) -> bool:
        if self.family in ("ssm",):
            return True
        if self.family == "hybrid":
            return True
        return self.max_window() is not None or any(
            l.kind == "attn" and l.window is not None for l in self.layout)

    def supports_decode(self) -> bool:
        return self.causal

    def reduced(self) -> "ModelConfig":
        """Smoke-test variant: <=2 periods, d_model<=256, <=4 experts."""
        period = len(self.layout)
        num_heads = min(self.num_heads, 4)
        kv_target = min(self.num_kv_heads, num_heads)
        num_kv = max(d for d in range(1, num_heads + 1)
                     if num_heads % d == 0 and d <= kv_target)
        layout = tuple(
            dataclasses.replace(l, window=min(l.window, 64) if l.window else l.window)
            for l in self.layout)
        return dataclasses.replace(
            self,
            num_layers=min(self.num_layers, 2 * period),
            d_model=min(self.d_model, 256),
            num_heads=num_heads,
            num_kv_heads=num_kv,
            head_dim=64 if self.head_dim else None,
            d_ff=min(self.d_ff, 512),
            d_ff_expert=min(self.d_ff_expert, 128) if self.d_ff_expert else 0,
            vocab_size=min(self.vocab_size, 512),
            num_experts=min(self.num_experts, 4) if self.num_experts else 0,
            experts_per_token=min(self.experts_per_token, 2) if self.experts_per_token else 0,
            ssm_state=min(self.ssm_state, 16) if self.ssm_state else 0,
            ssm_head_dim=32 if self.ssm_state else self.ssm_head_dim,
            num_patch_tokens=16 if self.frontend == "vision_stub" else self.num_patch_tokens,
            layout=layout,
            param_dtype="float32",
            compute_dtype="float32",
        )


@dataclasses.dataclass(frozen=True)
class ConvAudioConfig(ModelConfig):
    """A waveform encoder (``frontend="audio_conv"``): HuBERT's and wav2vec
    2.0's conv feature encoder over float32 samples (each conv with a bias,
    then LayerNorm over its channels and GELU: X-Large's ``conv_bias`` and
    ``feat_extract_norm="layer"``), a LayerNorm
    and a projection to ``d_model``, a learned mask embedding, the
    weight-normed grouped positional conv (``num_conv_pos_embeddings`` taps,
    ``num_conv_pos_embedding_groups`` groups), the block stack and HuBERT's
    masked-unit head: ``final_dim`` projection, cosine logits over
    ``vocab_size`` unit embeddings at temperature ``logit_temp``, plus
    ``feature_penalty`` times the encoder output's mean square. The
    defaults are HuBERT X-Large's (``facebook/hubert-xlarge-ll60k``)."""

    causal: bool = False
    frontend: str = "audio_conv"
    rmsnorm_eps: float = 1e-5  # the blocks' LayerNorm
    conv_dim: tuple[int, ...] = (512,) * 7
    conv_kernel: tuple[int, ...] = (10, 3, 3, 3, 3, 2, 2)
    conv_stride: tuple[int, ...] = (5, 2, 2, 2, 2, 2, 2)
    num_conv_pos_embeddings: int = 128
    num_conv_pos_embedding_groups: int = 16
    final_dim: int = 1024
    logit_temp: float = 0.1
    feature_penalty: float = 10.0

    def __post_init__(self):
        super().__post_init__()
        if not len(self.conv_dim) == len(self.conv_kernel) == len(self.conv_stride):
            raise ValueError("conv_dim, conv_kernel and conv_stride differ in length")
        if self.d_model % self.num_conv_pos_embedding_groups:
            raise ValueError(f"d_model {self.d_model} is not a multiple of "
                             f"{self.num_conv_pos_embedding_groups} positional conv groups")


@dataclasses.dataclass(frozen=True)
class HeldExpertsConfig(ModelConfig):
    """A MoE decoder of which this card holds ``num_experts`` consecutive
    experts, ids ``first_expert`` on, of the ``experts_total`` that the
    router spans: one share of an expert-parallel layer. Routing is dropless
    (no capacity): every (token, choice) pair whose expert is held is
    computed, and a pair of an absent expert adds nothing, which is the
    partial result that the card gives in expert parallelism. The combine
    weights are the token's top-``experts_per_token`` softmax probabilities
    over all ``experts_total`` experts, renormalised over the chosen
    (``norm_topk_probs``). ``load_balance="all_layers_topk"`` is the
    load-balance term of transformers' ``load_balancing_loss_func``, over
    all layers' routers at once and every top-k choice, at
    ``load_balance_coef``; it is computed from the whole router, so every
    share computes it alike. The defaults are Qwen3-30B-A3B's
    (``Qwen/Qwen3-30B-A3B``), every expert held."""

    arch_id: str = "qwen3-moe-30b-a3b"
    family: Family = "moe"
    num_layers: int = 48
    d_model: int = 2048
    num_heads: int = 32
    num_kv_heads: int = 4
    d_ff: int = 768
    vocab_size: int = 151936
    head_dim: int | None = 128
    qk_norm: bool = True
    rope_theta: float = 1_000_000.0
    layout: tuple[LayerSpec, ...] = (LayerSpec(kind="attn", mlp="moe"),)
    num_experts: int = 128  # held here
    experts_per_token: int = 8
    d_ff_expert: int = 768
    norm_topk_probs: bool = True
    param_dtype: str = "bfloat16"
    compute_dtype: str = "bfloat16"
    rmsnorm_eps: float = 1e-6
    source: str = "hf:Qwen/Qwen3-30B-A3B"
    experts_total: int = 128  # the router's width
    first_expert: int = 0
    load_balance: Literal["all_layers_topk"] = "all_layers_topk"
    load_balance_coef: float = 0.001

    def __post_init__(self):
        super().__post_init__()
        first, last = self.first_expert, self.first_expert + self.num_experts - 1
        if not 0 <= first <= last < self.experts_total:
            raise ValueError(f"experts {first}..{last} are not a share of the router's "
                             f"{self.experts_total}")
        if not 1 <= self.experts_per_token <= self.experts_total:
            raise ValueError(f"top-{self.experts_per_token} of {self.experts_total} experts")
        if self.load_balance != "all_layers_topk":
            raise ValueError(f"unknown load_balance {self.load_balance!r}")

    @property
    def copies_attn_scale(self) -> bool:
        return False
