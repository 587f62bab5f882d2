"""qwen3-moe-30b-a3b [moe]: 48L d_model=2048 32H (GQA kv=4) vocab=151936,
MoE 128 experts top-8, expert d_ff=768 [hf:Qwen/Qwen3-30B-A3B]."""

from repro_torch.models.config import LayerSpec, ModelConfig


def get_config() -> ModelConfig:
    return ModelConfig(
        arch_id="qwen3-moe-30b-a3b",
        family="moe",
        num_layers=48,
        d_model=2048,
        num_heads=32,
        num_kv_heads=4,
        head_dim=128,
        d_ff=768,  # kept for the assignment table; layers use d_ff_expert
        vocab_size=151936,
        qk_norm=True,
        rope_theta=1_000_000.0,
        layout=(LayerSpec(kind="attn", mlp="moe"),),
        num_experts=128,
        experts_per_token=8,
        d_ff_expert=768,
        norm_topk_probs=True,
        param_dtype="bfloat16",
        source="hf:Qwen/Qwen3-30B-A3B",
    )
