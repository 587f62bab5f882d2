"""Seeded violations for the port's `traced-host-sync` rule.

``body`` is captured (the first argument of ``Graphed``), ``lockstep``'s
returned closure is captured (``Graphed(lockstep(...))``), so is the body of
the ``torch.cuda.graph`` block and each callable given to
``make_graphed_callables``; ``host_report`` is plain host code and must NOT
be flagged even though it uses the same calls.
"""

import random
import time

import numpy as np
import torch

from repro_torch.core.executor import Graphed


def helper(x):
    # Reached from the captured `body` below.
    return x.item()  # VIOLATION


def body(inp):
    x = inp["x"]
    t = time.time()  # VIOLATION
    jitter = random.random()  # VIOLATION
    host = np.asarray(x)  # VIOLATION
    scale = float(x.sum())  # VIOLATION
    ys = x.tolist()  # VIOLATION
    on_host = x.cpu()  # VIOLATION
    arr = on_host.numpy()  # VIOLATION
    torch.cuda.synchronize()  # VIOLATION
    made = torch.tensor([1.0, 2.0], device=x.device)  # VIOLATION
    return {"x": x * scale + helper(x) + t + jitter + host.sum() + len(ys) + arr.sum()
            + made.sum()}


def lockstep(length: int, scale: float):
    def fn(inp):
        w = inp["w"]
        for _ in range(length):
            w = w * float(scale)  # a float parameter: no tensor is read
            if bool(w.any()):  # VIOLATION
                w = w + int(w.argmax())  # VIOLATION
        return {"w": w}

    return fn


def run(inputs, device):
    Graphed(body, device, "lockstep")(inputs)
    Graphed(lockstep(3, 0.5), device, "lockstep")(inputs)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        total = inputs["x"].sum()
        count = total.item()  # VIOLATION
    layer = torch.cuda.make_graphed_callables(graphed_layer, (inputs["x"],))
    return count, layer


def graphed_layer(x):
    return x * torch.as_tensor(2.0)  # VIOLATION


def host_report(result):
    # Host-side by design: unreachable from any capture.
    print(f"{time.time()}: {float(result.sum()):.3f}", np.asarray(result.cpu()),
          result.tolist(), result.item())
