"""Zipf token batches made on the device from a seed.

The distribution of ``data/synthetic.py`` ``make_token_dataset`` (token
rank r drawn with probability proportional to r ** -exponent), drawn batch
by batch by inverting the cumulative distribution at uniform draws (float64;
``torch.multinomial`` on the card does not repeat its draws for a seed):
batch i of a stream is (batch, seq + 1) tokens, with ``tokens`` the first
seq and ``labels`` the next-token shift. The stream's batches all differ,
and the same seed gives the same stream.
"""

from __future__ import annotations

import numpy as np
import torch


class TokenStream:
    def __init__(self, vocab: int, batch: int, seq: int, exponent: float, seed: int,
                 device: torch.device):
        cdf = np.cumsum(np.arange(1, vocab + 1, dtype=np.float64) ** -exponent)
        self.cdf = torch.from_numpy(cdf / cdf[-1]).to(device)
        self.vocab, self.batch, self.seq = vocab, batch, seq
        self.generator = torch.Generator(device=device)
        self.generator.manual_seed(seed)

    def next_batch(self) -> dict:
        u = torch.rand(self.batch * (self.seq + 1), generator=self.generator,
                       device=self.cdf.device, dtype=torch.float64)
        draw = torch.searchsorted(self.cdf, u, right=True).clamp_(max=self.vocab - 1)
        arr = draw.reshape(self.batch, self.seq + 1)
        return {"tokens": arr[:, :-1].contiguous(), "labels": arr[:, 1:].contiguous()}
