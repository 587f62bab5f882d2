"""HuBERT's training batches made on the device from a seed.

A batch of ``batch`` crops of ``seq`` frames (``inputs/hubert_weights.py``
``samples`` gives the samples they take) holds:

* ``waveform`` (batch, samples) float32, standard normal, as normalised
  audio is;
* ``labels`` (batch, seq): a unit a frame, unit rank r drawn with
  probability proportional to r ** -``label_zipf`` (uneven cluster use), by
  inverting the cumulative distribution at uniform draws (float64), as
  ``inputs/tokens.py`` draws tokens;
* ``mask`` (batch, seq) bool: fairseq's span masking as HuBERT pre-trains
  with it (``mask_prob`` p, ``mask_length`` L): n = max(2, int(p seq / L +
  u)) span starts a batch (u uniform, from a host generator, so that no
  count is read from the card), drawn per crop without replacement from
  the first seq - L frames, each masking L frames; spans may overlap.

The same seed gives the same stream, and its batches all differ.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from perfbench.inputs.hubert_weights import samples


def span_count(seq: int, p: float, length: int, u: float) -> int:
    return max(2, min(int(p * seq / length + u), seq - length))


def expected_masked_frames(seq: int, p: float, length: int) -> float:
    """The mean number of frames a crop's mask covers (exact, over u and the starts)."""
    frac = p * seq / length % 1.0  # u below 1 - frac adds no span
    counts: dict[int, float] = {}
    for n, weight in ((span_count(seq, p, length, 0.0), 1.0 - frac),
                      (span_count(seq, p, length, 1.0 - 1e-12), frac)):
        counts[n] = counts.get(n, 0.0) + weight
    starts = seq - length
    total = 0.0
    for n, weight in counts.items():
        if weight == 0:
            continue
        ways = math.comb(starts, n)
        for f in range(seq):
            covering = max(0, min(f, starts - 1) - max(0, f - length + 1) + 1)
            total += weight * (1.0 - math.comb(starts - covering, n) / ways)
    return total


class AudioStream:
    def __init__(self, config: dict, traffic: dict, seed: int, device: torch.device):
        vocab = config["vocab_size"]
        cdf = np.cumsum(np.arange(1, vocab + 1, dtype=np.float64) ** -traffic["label_zipf"])
        self.cdf = torch.from_numpy(cdf / cdf[-1]).to(device)
        self.vocab, self.batch, self.seq = vocab, traffic["batch"], traffic["seq"]
        self.samples = samples(config, self.seq)
        self.p, self.length = traffic["mask_prob"], traffic["mask_length"]
        self.generator = torch.Generator(device=device)
        self.generator.manual_seed(seed)
        self.host = torch.Generator()
        self.host.manual_seed(seed)
        self.device = device

    def next_batch(self) -> dict:
        B, S, L, g, dev = self.batch, self.seq, self.length, self.generator, self.device
        wave = torch.randn((B, self.samples), generator=g, device=dev, dtype=torch.float32)
        u = torch.rand(B * S, generator=g, device=dev, dtype=torch.float64)
        labels = torch.searchsorted(self.cdf, u, right=True).clamp_(max=self.vocab - 1)
        n = span_count(S, self.p, L, float(torch.rand((), generator=self.host)))
        starts = torch.rand((B, S - L), generator=g, device=dev).argsort(dim=1)[:, :n]
        frames = (starts[..., None] + torch.arange(L, device=dev)).reshape(B, -1)
        mask = torch.zeros((B, S), dtype=torch.bool, device=dev)
        mask.scatter_(1, frames, True)
        return {"waveform": wave, "mask": mask, "labels": labels.reshape(B, S)}
