"""hubert-xlarge [audio]: 48L d_model=1280 16H (MHA kv=16) d_ff=5120
vocab=504 (cluster units), encoder-only, w2v2 architecture [arXiv:2106.07447].

The conv/mel frontend is the allowed stub: batches carry precomputed frame
embeddings at d_model. Bidirectional attention (causal=False); masked-unit
prediction is proxied by CE over all frames. No autoregressive decode exists,
so decode_32k and long_500k are skipped for this arch (DESIGN §5). HuBERT's
convolutional relative positional embedding is replaced by RoPE (adaptation
note: positional scheme is orthogonal to the compute/communication profile
measured here).

This config mirrors the JAX package's stand-in and stays for the parity
tests. The published model (conv waveform encoder, conv positions, pre-LN
GELU blocks with biases, the masked-unit loss) is the port's
``models.config.ConvAudioConfig`` with ``frontend="audio_conv"``, built from
``perfbench/configs/hubert-xlarge.json``.
"""

from repro_torch.models.config import LayerSpec, ModelConfig


def get_config() -> ModelConfig:
    return ModelConfig(
        arch_id="hubert-xlarge",
        family="audio",
        num_layers=48,
        d_model=1280,
        num_heads=16,
        num_kv_heads=16,
        head_dim=80,
        d_ff=5120,
        vocab_size=504,
        causal=False,
        rope_theta=10_000.0,
        layout=(LayerSpec(kind="attn", mlp="dense"),),
        frontend="audio_stub",
        param_dtype="bfloat16",
        source="arXiv:2106.07447 (HuBERT)",
    )
