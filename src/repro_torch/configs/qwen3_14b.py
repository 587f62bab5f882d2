"""qwen3-14b [dense]: 40L d_model=5120 40H (GQA kv=8) d_ff=17408 vocab=151936.

qk_norm + GQA per the Qwen3 family [hf:Qwen/Qwen3-8B]; head_dim=128 is
decoupled from d_model/num_heads as in Qwen3 model cards.
"""

from repro_torch.models.config import LayerSpec, ModelConfig


def get_config() -> ModelConfig:
    return ModelConfig(
        arch_id="qwen3-14b",
        family="dense",
        num_layers=40,
        d_model=5120,
        num_heads=40,
        num_kv_heads=8,
        head_dim=128,
        d_ff=17408,
        vocab_size=151936,
        qk_norm=True,
        rope_theta=1_000_000.0,
        layout=(LayerSpec(kind="attn", mlp="dense"),),
        param_dtype="bfloat16",
        source="hf:Qwen/Qwen3-8B (family card; 14B dims per assignment)",
    )
