"""pixtral-12b [vlm]: 40L d_model=5120 32H (GQA kv=8) d_ff=14336 vocab=131072.

Pixtral ViT frontend + Mistral-Nemo decoder [hf:mistralai/Pixtral-12B-2409].
The ViT + projector are the allowed stub: batches carry precomputed patch
embeddings (1024 per sequence by default) that a learned linear projector maps
into the decoder stream; loss is computed on text positions only.
"""

from repro_torch.models.config import LayerSpec, ModelConfig


def get_config() -> ModelConfig:
    return ModelConfig(
        arch_id="pixtral-12b",
        family="vlm",
        num_layers=40,
        d_model=5120,
        num_heads=32,
        num_kv_heads=8,
        head_dim=128,
        d_ff=14336,
        vocab_size=131072,
        rope_theta=1_000_000.0,
        layout=(LayerSpec(kind="attn", mlp="dense"),),
        frontend="vision_stub",
        num_patch_tokens=1024,
        param_dtype="bfloat16",
        source="hf:mistralai/Pixtral-12B-2409",
    )
