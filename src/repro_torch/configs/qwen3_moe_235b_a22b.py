"""qwen3-moe-235b-a22b [moe]: 94L d_model=4096 64H (GQA kv=4) vocab=151936,
MoE 128 experts top-8, expert d_ff=1536 [hf:Qwen/Qwen3-30B-A3B family card]."""

from repro_torch.models.config import LayerSpec, ModelConfig


def get_config() -> ModelConfig:
    return ModelConfig(
        arch_id="qwen3-moe-235b-a22b",
        family="moe",
        num_layers=94,
        d_model=4096,
        num_heads=64,
        num_kv_heads=4,
        head_dim=128,
        d_ff=1536,  # kept for the assignment table; layers use d_ff_expert
        vocab_size=151936,
        qk_norm=True,
        rope_theta=1_000_000.0,
        layout=(LayerSpec(kind="attn", mlp="moe"),),
        num_experts=128,
        experts_per_token=8,
        d_ff_expert=1536,
        norm_topk_probs=True,
        param_dtype="bfloat16",
        source="hf:Qwen/Qwen3-30B-A3B (family card; 235B dims per assignment)",
    )
