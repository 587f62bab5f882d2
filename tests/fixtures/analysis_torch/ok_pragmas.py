"""The negative fixture: every violation class, each pragma-suppressed.

Must produce ZERO findings -- asserts the pragma grammar end to end
(the `host-ok` / `fail-fast-ok` aliases, `ignore[rule]`, def-scoped
suppression).
"""

import time

import torch
from torch.distributed.device_mesh import init_device_mesh

from repro_torch.core.executor import Graphed


def body(inp):
    t = time.time()  # analysis: host-ok
    return {"x": inp["x"] + t}


def body2(inp):  # analysis: ignore[traced-host-sync]
    # Def-scoped pragma: suppresses every line in this function.
    return {"x": inp["x"] * float(inp["x"].sum()) + inp["x"].item()}


def run(inputs, device):
    Graphed(body, device, "lockstep")(inputs)
    Graphed(body2, device, "lockstep")(inputs)
    return init_device_mesh("cuda", (1,))  # analysis: ignore[mesh-via-make-mesh]


def serve_guard(run):
    try:
        return run()
    except Exception:  # analysis: fail-fast-ok (the serve loop's last resort)
        return None


def anything():
    return torch.tensor(1.0).item()  # analysis: ignore
