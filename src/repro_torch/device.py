"""Device resolution shared by every entry point of the port."""

from __future__ import annotations

import torch


def resolve_device(device: str | torch.device | None = None) -> torch.device:
    """The device an entry point runs on: CUDA unless the caller names another.

    With ``device=None`` and no CUDA device present this raises instead of
    carrying on quietly on the CPU; pass ``device="cpu"`` to ask for the host.
    """
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device is available; pass device='cpu' to run on "
                "the host")
        device = "cuda"
    dev = torch.device(device)
    if dev.type == "cuda" and dev.index is None:
        # Name the card, as tensors' devices do, so devices compare equal.
        dev = torch.device("cuda", torch.cuda.current_device())
    return dev
