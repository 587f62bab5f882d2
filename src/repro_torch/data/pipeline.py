"""Token batch pipeline: deterministic, resumable, placed on the pipeline's device.

PyTorch counterpart of ``repro.data.pipeline.TokenPipeline`` for text
models: the same Zipf token stream from the same seed
(:func:`repro_torch.data.synthetic.make_token_dataset`, draw for draw the
JAX package's), packed into (batch, seq) examples with next-token labels,
and a cursor for checkpoint and resume. On one card there is no mesh to
shard a batch over: each batch is copied to ``device`` whole. Tokens and
labels are int64, PyTorch's index type (the JAX package's are int32 with
the same values). The vision and audio stubs wait for their frontends
(ROADMAP A7).
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
        if self.cfg.frontend != "text":
            raise NotImplementedError(f"the {self.cfg.frontend} frontend's batches are not "
                                      "ported yet (ROADMAP A7)")
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
        self.step += 1
        return {"tokens": arr[:, :-1].to(self.device), "labels": arr[:, 1:].to(self.device)}

    def state_dict(self) -> dict:
        return {"step": self.step, "seed": self.seed}

    def load_state_dict(self, state: dict) -> None:
        self.step = int(state["step"])
