"""The device inventory the experiment service reports.

PyTorch counterpart of ``repro.launch.mesh.device_summary`` only; the rest
of that module (production meshes, sharding helpers) is not ported yet.
"""

from __future__ import annotations

import torch


def device_summary(device: str | torch.device) -> dict:
    """The accelerator inventory behind ``device`` as a plain dict, for the
    experiment service's ``GET /stats``: ``platform`` (``gpu`` or ``cpu``),
    ``device_count``, ``kind`` (the card's name) and ``sweep_shards`` -- 1,
    since a port sweep runs on its problem's one device."""
    dev = torch.device(device)
    if dev.type == "cuda":
        return {"platform": "gpu", "device_count": torch.cuda.device_count(),
                "kind": torch.cuda.get_device_name(dev), "sweep_shards": 1}
    return {"platform": "cpu", "device_count": 1, "kind": "cpu", "sweep_shards": 1}
