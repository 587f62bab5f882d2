"""jamba-1.5-large-398b [hybrid]: 72L d_model=8192 64H (GQA kv=8) d_ff=24576
vocab=65536, MoE 16 experts top-2, Mamba:attention 7:1 [arXiv:2403.19887].

Period of 8 layers (9 periods = 72): attention at position 4, Mamba elsewhere;
MoE on odd positions (every other layer), dense MLP on even -- matching the
paper's 1-attention-in-8 and MoE-every-2 structure. The Mamba mixer uses our
SSD (mamba2-style) block with state 128 / head_dim 64; Jamba-1 ships mamba1
(d_state 16) -- SSD is the TPU-idiomatic choice and is noted as an adaptation
in DESIGN.md. long_500k is RUN: 63/72 layers are O(1)-state SSD and the 9
attention layers sequence-shard their 524k cache.
"""

from repro_torch.models.config import LayerSpec, ModelConfig


def _layout() -> tuple[LayerSpec, ...]:
    out = []
    for pos in range(8):
        kind = "attn" if pos == 4 else "mamba"
        mlp = "moe" if pos % 2 == 1 else "dense"
        out.append(LayerSpec(kind=kind, mlp=mlp, window=None))
    return tuple(out)


def get_config() -> ModelConfig:
    return ModelConfig(
        arch_id="jamba-1.5-large-398b",
        family="hybrid",
        num_layers=72,
        d_model=8192,
        num_heads=64,
        num_kv_heads=8,
        head_dim=128,
        d_ff=24576,
        vocab_size=65536,
        rope_theta=10_000.0,
        layout=_layout(),
        num_experts=16,
        experts_per_token=2,
        d_ff_expert=24576,
        ssm_state=128,
        ssm_expand=2,
        ssm_head_dim=64,
        param_dtype="bfloat16",
        source="arXiv:2403.19887 (Jamba); 1.5-large dims per assignment",
    )
