"""codeqwen1.5-7b [dense]: 32L d_model=4096 32H (kv=32, i.e. MHA) d_ff=13440
vocab=92416. Qwen1.5 architecture [hf:Qwen/CodeQwen1.5-7B]."""

from repro_torch.models.config import LayerSpec, ModelConfig


def get_config() -> ModelConfig:
    return ModelConfig(
        arch_id="codeqwen1.5-7b",
        family="dense",
        num_layers=32,
        d_model=4096,
        num_heads=32,
        num_kv_heads=32,
        head_dim=128,
        d_ff=13440,
        vocab_size=92416,
        rope_theta=1_000_000.0,
        layout=(LayerSpec(kind="attn", mlp="dense"),),
        param_dtype="bfloat16",
        source="hf:Qwen/CodeQwen1.5-7B",
    )
