"""Model stack of the port: dense, MoE, SSM (Mamba2) and hybrid text models
on one stage substrate (qwen3, qwen3-moe, phi3, codeqwen, mamba2, jamba)."""

from repro_torch.models.config import LayerSpec, ModelConfig  # noqa: F401
from repro_torch.models.model import (  # noqa: F401
    decode_step,
    init_caches,
    model_spec,
    prefill,
    train_loss,
)
from repro_torch.models import param  # noqa: F401
