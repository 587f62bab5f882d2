"""Parameter plans: shapes declared separately from values.

PyTorch counterpart of ``repro.models.param``. Every module declares its
parameters as a nested dict of :class:`ParamSpec` (shape, dtype, logical
axis names, initializer); :func:`tree_materialize` turns the plan into
tensors and :func:`num_params` counts it without allocating anything.

The JAX package's mesh and sharding rules are not ported: on one card every
rule resolves to no sharding, and its ``constraint`` is the identity there.

The init rule is the JAX package's, unchanged: a ``normal`` leaf has
std = ``1/sqrt(shape[0])`` for a leaf of two or more dims. For a leaf
stacked over layers by :func:`stack_specs`, ``shape[0]`` is the layer count,
so a stacked ``wq (40, 5120, 5120)`` gets std 1/sqrt(40). The port keeps
that (see :func:`init_std`).
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Callable, Iterator

import torch

PyTree = Any

# Largest float32 temporary one draw makes: a big leaf is drawn in slices
# along its first axis (a stacked leaf layer by layer), straight on the
# device, so the float32 copy of a (40, 5120, 17408) MLP stack never exists
# whole.
_DRAW_BYTES = 1 << 30


@dataclasses.dataclass(frozen=True)
class ParamSpec:
    shape: tuple[int, ...]
    dtype: torch.dtype
    axes: tuple[str | None, ...]  # logical axis name per dim (None = anonymous)
    init: str = "normal"  # "normal" | "zeros" | "ones"
    scale: float | None = None  # stddev override; None -> 1/sqrt(fan_in)

    def __post_init__(self):
        if len(self.shape) != len(self.axes):
            raise ValueError(f"shape {self.shape} and axes {self.axes} differ in rank")

    def materialize(self, generator: torch.Generator,
                    device: torch.device) -> torch.Tensor:
        if self.init == "zeros":
            return torch.zeros(self.shape, dtype=self.dtype, device=device)
        if self.init == "ones":
            return torch.ones(self.shape, dtype=self.dtype, device=device)
        std = init_std(self)
        out = torch.empty(self.shape, dtype=self.dtype, device=device)
        rows = self.shape[0] if len(self.shape) > 1 else 1
        per_row = math.prod(self.shape) // max(rows, 1) * 4
        step = max(1, _DRAW_BYTES // max(per_row, 1))
        flat = out.view(rows, -1) if len(self.shape) > 1 else out.view(1, -1)
        for lo in range(0, rows, step):
            hi = min(rows, lo + step)
            draw = torch.randn((hi - lo, flat.shape[1]), generator=generator,
                               device=device, dtype=torch.float32)
            flat[lo:hi] = (draw * std).to(self.dtype)
        return out


def init_std(spec: ParamSpec) -> float:
    """The std a ``normal`` leaf is drawn with: the JAX package's rule."""
    fan_in = spec.shape[0] if len(spec.shape) > 1 else max(spec.shape[-1], 1)
    return spec.scale if spec.scale is not None else 1.0 / math.sqrt(fan_in)


def tree_map(fn: Callable, tree: PyTree) -> PyTree:
    """Apply ``fn`` to every leaf of a nested dict, keeping the nesting."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v) for k, v in tree.items()}
    return fn(tree)


def tree_leaves_with_path(tree: PyTree, prefix: str = "") -> Iterator[tuple[str, Any]]:
    """``(dotted path, leaf)`` pairs in insertion order, e.g. ``stage0.pos0.attn.wq``."""
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from tree_leaves_with_path(v, f"{prefix}.{k}" if prefix else k)
    else:
        yield prefix, tree


def tree_flatten(tree: PyTree) -> tuple[list, Callable[[list], PyTree]]:
    """The leaves of a nested dict in the JAX package's order (keys sorted at
    every level, as ``jax.tree.leaves`` takes them), and a function that
    builds the same nesting around a list of new leaves in that order.

    The walks are module functions, not closures that call themselves: such
    a closure is a reference cycle, and would keep the leaves it saw (a
    step's gradients) alive until the cyclic collector ran."""
    leaves: list = []
    skeleton = _skeleton(tree, leaves)
    return leaves, lambda new: _build(skeleton, new)


def _skeleton(tree: PyTree, leaves: list) -> PyTree:
    if isinstance(tree, dict):
        return {k: _skeleton(tree[k], leaves) for k in sorted(tree)}
    leaves.append(tree)
    return len(leaves) - 1


def _build(skeleton: PyTree, new: list) -> PyTree:
    if isinstance(skeleton, dict):
        return {k: _build(v, new) for k, v in skeleton.items()}
    return new[skeleton]


def stack_specs(spec: PyTree, num: int) -> PyTree:
    """Prepend a ``layers`` axis of size ``num`` to every leaf."""
    return tree_map(lambda s: ParamSpec((num, *s.shape), s.dtype, ("layers", *s.axes),
                                        s.init, s.scale), spec)


def num_params(spec: PyTree) -> int:
    return sum(math.prod(s.shape) for _, s in tree_leaves_with_path(spec))


def tree_materialize(spec: PyTree, generator: torch.Generator,
                     device: str | torch.device) -> PyTree:
    """Draw every leaf on ``device`` from ``generator``, leaf by leaf.

    The values follow the JAX package's init rule in distribution, not draw
    for draw: ``jax.random`` and ``torch.Generator`` give different streams.
    To carry the JAX package's own weights across, use
    :func:`repro_torch.convert.params_from_arrays`.
    """
    dev = torch.device(device)
    return tree_map(lambda s: s.materialize(generator, dev), spec)
