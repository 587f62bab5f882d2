"""gemma3-27b [dense]: 62L d_model=5376 32H (GQA kv=16) d_ff=21504
vocab=262144; 5:1 local(sliding 1024):global interleave, 128k+ context
[hf:google/gemma-3-1b-pt family card].

62 layers = 10 full (5 local + 1 global) periods + a 2-layer remainder stage
(see ModelConfig.stages). Single rope_theta=1e6 is used for both local and
global layers (the released model uses 10k local / 1M global; the split is
orthogonal to everything measured here and is noted as an adaptation).
long_500k is RUN for this arch: local layers keep 1024-slot ring caches and
the 10+1 global layers sequence-shard their 524k cache over the mesh.
"""

from repro_torch.models.config import LayerSpec, ModelConfig

LOCAL = LayerSpec(kind="attn", mlp="dense", window=1024)
GLOBAL = LayerSpec(kind="attn", mlp="dense", window=None)


def get_config() -> ModelConfig:
    return ModelConfig(
        arch_id="gemma3-27b",
        family="dense",
        num_layers=62,
        d_model=5376,
        num_heads=32,
        num_kv_heads=16,
        head_dim=128,
        d_ff=21504,
        vocab_size=262144,
        qk_norm=True,
        rope_theta=1_000_000.0,
        attn_logit_softcap=None,  # gemma3 dropped gemma2's softcap
        layout=(LOCAL, LOCAL, LOCAL, LOCAL, LOCAL, GLOBAL),
        param_dtype="bfloat16",
        source="hf:google/gemma-3-1b-pt (family card; 27B dims per assignment)",
    )
