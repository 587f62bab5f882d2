"""The solver runs' visit orders, drawn on the device from a run's seed.

A draw source with the port's interface (``root``, ``split``, ``randint``):
every ``randint(keys, n, num)`` call draws one ``(len(keys), num)`` block of
uniform int32 indices in ``[0, n)`` from one generator, in call order. The
benchmark hands it to the program's ``Session(draws=...)``, and the
reference, which makes the same calls in the protocol's order, draws the
same orders from a source built from the same seed.
"""

from __future__ import annotations

import torch


class Draws:
    def __init__(self, seed: int, device):
        self.generator = torch.Generator(device=device)
        self.generator.manual_seed(seed)
        self.device = torch.device(device)

    def root(self):
        return None

    def split(self, key, num: int) -> list:
        return [None] * num

    def randint(self, keys, n: int, num: int) -> torch.Tensor:
        return torch.randint(0, n, (len(keys), num), generator=self.generator,
                             device=self.device, dtype=torch.int32)
