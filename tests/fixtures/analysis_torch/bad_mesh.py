"""Seeded violations for the port's `mesh-via-make-mesh` rule (not under
launch/mesh.py, so every direct construction is flagged)."""

import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh, init_device_mesh


def build(world: int):
    mesh = init_device_mesh("cuda", (world,))  # VIOLATION
    again = DeviceMesh("cuda", list(range(world)))  # VIOLATION
    return mesh, again, dist.get_world_size()
