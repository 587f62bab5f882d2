"""mamba2-780m [ssm]: 48L d_model=1536 (attention-free) vocab=50280,
SSD state=128, expand=2, head_dim=64 -> 48 SSD heads [arXiv:2405.21060].

No MLP sublayer (Mamba2 blocks are mixer-only). All decode shapes including
long_500k run: state is O(1) in context.
"""

from repro_torch.models.config import LayerSpec, ModelConfig


def get_config() -> ModelConfig:
    return ModelConfig(
        arch_id="mamba2-780m",
        family="ssm",
        num_layers=48,
        d_model=1536,
        num_heads=1,  # unused (attention-free); keeps dataclass invariants
        num_kv_heads=1,
        d_ff=0,
        vocab_size=50280,
        layout=(LayerSpec(kind="mamba", mlp="none"),),
        ssm_state=128,
        ssm_expand=2,
        ssm_head_dim=64,
        param_dtype="bfloat16",
        source="arXiv:2405.21060 (Mamba2 / SSD)",
    )
