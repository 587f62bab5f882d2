"""Model stack of the port: dense attention text models (qwen3, phi3, codeqwen)."""

from repro_torch.models.config import LayerSpec, ModelConfig  # noqa: F401
from repro_torch.models.model import (  # noqa: F401
    decode_step,
    init_caches,
    model_spec,
    prefill,
    train_loss,
)
from repro_torch.models import param  # noqa: F401
