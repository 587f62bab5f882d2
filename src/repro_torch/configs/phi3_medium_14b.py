"""phi3-medium-14b [dense]: 40L d_model=5120 40H (GQA kv=10) d_ff=17920
vocab=100352. RoPE + SwiGLU + GQA [arXiv:2404.14219].

kv=10 gives G = 4 query heads a KV head.
"""

from repro_torch.models.config import LayerSpec, ModelConfig


def get_config() -> ModelConfig:
    return ModelConfig(
        arch_id="phi3-medium-14b",
        family="dense",
        num_layers=40,
        d_model=5120,
        num_heads=40,
        num_kv_heads=10,
        head_dim=128,
        d_ff=17920,
        vocab_size=100352,
        rope_theta=10_000.0,
        layout=(LayerSpec(kind="attn", mlp="dense"),),
        param_dtype="bfloat16",
        source="arXiv:2404.14219 (Phi-3 technical report)",
    )
