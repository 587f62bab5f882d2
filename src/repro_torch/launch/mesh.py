"""The device inventory the experiment service reports, and mesh shape arithmetic.

PyTorch counterpart of ``repro.launch.mesh``. ``device_summary`` describes
the card (or host) behind a device. The JAX package's production meshes
(one 16 x 16 pod, or two) are kept as their shapes only: a mesh-shape dict
``{axis: size}``, the form ``launch/analytic.py`` reads, with the data-axis
arithmetic of the JAX module (``data_axes``, ``batch_divisor``,
``_pow2_floor``). Building a device mesh is not ported: the port runs on one
card, and on one card the dry-run's meshes change only its analytic terms
(``launch/dryrun.py``).
"""

from __future__ import annotations

import torch

# One card; one 16 x 16 pod (256 chips); two pods (512 chips).
MESH_SHAPES = {"single": {"data": 1, "model": 1}, "production": {"data": 16, "model": 16},
               "multi": {"pod": 2, "data": 16, "model": 16}}


def num_devices(mesh_shape: dict[str, int]) -> int:
    out = 1
    for size in mesh_shape.values():
        out *= size
    return out


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


def _pow2_floor(n: int) -> int:
    return 1 << (max(1, n).bit_length() - 1)


def data_axes(mesh_shape: dict[str, int]) -> tuple[str, ...]:
    """The axes a batch is split over, outermost first: ``pod``, ``data``."""
    return tuple(a for a in ("pod", "data") if a in mesh_shape)


def batch_divisor(mesh_shape: dict[str, int]) -> int:
    """How many ways the data axes split a batch."""
    out = 1
    for a in data_axes(mesh_shape):
        out *= mesh_shape[a]
    return out
