"""Token batch pipeline: deterministic, resumable, placed on the pipeline's device.

PyTorch counterpart of ``repro.data.pipeline.TokenPipeline``: the same
Zipf token stream from the same seed
(:func:`repro_torch.data.synthetic.make_token_dataset`, draw for draw the
JAX package's), packed into (batch, seq) examples with next-token labels,
and a cursor for checkpoint and resume. On one card there is no mesh to
shard a batch over: each batch is copied to ``device`` whole. Tokens and
labels are int64, PyTorch's index type (the JAX package's are int32 with
the same values).

The frontends' stubs, as in the JAX package: a VLM batch carries
``patch_embeds`` (B, p, d_model), p = min(num_patch_tokens, seq_len // 2),
and its text cut to ``seq_len - p`` so that the stream is seq_len long; an
audio batch carries ``frame_embeds`` (B, seq_len, d_model) and the labels,
no tokens. Both are standard normal draws from ``default_rng(seed +
step)`` (float32, times 0.02, then the compute dtype), equal to JAX's.
"""

from __future__ import annotations

import dataclasses
from typing import Iterator

import numpy as np
import torch

from repro_torch.data.synthetic import make_token_dataset
from repro_torch.device import resolve_device
from repro_torch.models.config import ModelConfig


@dataclasses.dataclass
class TokenPipeline:
    cfg: ModelConfig
    batch_size: int
    seq_len: int
    seed: int = 0
    num_tokens: int | None = None  # synthetic stream size (default: 64 batches)
    step: int = 0  # cursor, checkpointable
    device: str | torch.device | None = None  # the card unless named

    def __post_init__(self):
        self.device = resolve_device(self.device)
        need = self.num_tokens or 64 * self.batch_size * (self.seq_len + 1)
        self._stream = make_token_dataset(need, self.cfg.vocab_size, self.seed)
        self._per_batch = self.batch_size * (self.seq_len + 1)
        self._num_batches = len(self._stream) // self._per_batch

    def __iter__(self) -> Iterator[dict]:
        while True:
            yield self.next_batch()

    def next_batch(self) -> dict:
        i = self.step % self._num_batches
        chunk = self._stream[i * self._per_batch : (i + 1) * self._per_batch]
        arr = torch.from_numpy(chunk.reshape(self.batch_size, self.seq_len + 1)
                               .astype(np.int64))
        batch = self._make_batch(arr)
        self.step += 1
        return {k: v.to(self.device) for k, v in batch.items()}

    def _embeds(self, length: int) -> torch.Tensor:
        """(B, length, d_model) stub embeddings of this step, as JAX draws them."""
        rng = np.random.default_rng(self.seed + self.step)
        draw = rng.standard_normal((self.batch_size, length, self.cfg.d_model))
        return torch.from_numpy(draw.astype(np.float32) * 0.02).to(self.cfg.cdtype)

    def _make_batch(self, arr: torch.Tensor) -> dict:
        tokens, labels = arr[:, :-1], arr[:, 1:]
        cfg = self.cfg
        if cfg.frontend == "text":
            return {"tokens": tokens, "labels": labels}
        if cfg.frontend == "vision_stub":
            p = min(cfg.num_patch_tokens, self.seq_len // 2)
            return {"tokens": tokens[:, : self.seq_len - p],
                    "labels": labels[:, : self.seq_len - p],
                    "patch_embeds": self._embeds(p)}
        if cfg.frontend == "audio_stub":
            return {"frame_embeds": self._embeds(self.seq_len), "labels": labels}
        raise ValueError(cfg.frontend)

    def state_dict(self) -> dict:
        return {"step": self.step, "seed": self.seed}

    def load_state_dict(self, state: dict) -> None:
        self.step = int(state["step"])
