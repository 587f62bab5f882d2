"""Rounding helpers of the references and their lower-precision controls.

``matmul(a, b, precision)`` is every matrix or vector product of the
references: IEEE float32 (TF32 off) by default. The controls put a lower
precision in the same places, as the step a faster program would be tempted
to take: ``"tf32"`` rounds both operands to TF32 (10 mantissa bits, to
nearest with ties away from zero, as the tensor cores convert them) and
sums in float32; ``"fp8"`` computes as the program does in its compute type, one
type lower: each operand and each result of a product is scaled by its
largest magnitude to float8 e4m3's range and rounded to e4m3 (where the
program rounds them to bf16), the sums in float32; forward and backward
alike, as float8 training does.
"""

from __future__ import annotations

import contextlib

import torch

FP8_MAX = 448.0  # largest finite float8 e4m3fn


@contextlib.contextmanager
def ieee_float32():
    """Matrix products in IEEE float32 inside the block, whatever the default."""
    prev = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = prev


def round_tf32(x: torch.Tensor) -> torch.Tensor:
    """One temporary the size of ``x``, rounded in place."""
    bits = x.to(torch.float32).contiguous().view(torch.int32) + 0x1000
    return bits.bitwise_and_(-0x2000).view(torch.float32)


def round_fp8(x: torch.Tensor) -> torch.Tensor:
    x = x.to(torch.float32)
    scale = FP8_MAX / torch.clamp(torch.amax(torch.abs(x)), min=1e-30)
    return (x * scale).to(torch.float8_e4m3fn).to(torch.float32) / scale


class _Fp8Matmul(torch.autograd.Function):
    @staticmethod
    def forward(ctx, a, b):
        a8, b8 = round_fp8(a), round_fp8(b)
        ctx.save_for_backward(a8, b8)
        return round_fp8(a8 @ b8)

    @staticmethod
    def backward(ctx, g):
        a8, b8 = ctx.saved_tensors
        g8 = round_fp8(g)
        return round_fp8(g8 @ b8.transpose(-1, -2)), round_fp8(a8.transpose(-1, -2) @ g8)


def matmul(a: torch.Tensor, b: torch.Tensor, precision: str = "float32") -> torch.Tensor:
    with ieee_float32():
        if precision == "float32":
            return a @ b
        if precision == "tf32":
            return round_tf32(a) @ round_tf32(b)
        if precision == "fp8":
            return _Fp8Matmul.apply(a, b)
    raise ValueError(f"unknown precision {precision!r}")


def rel(a: float, b: float) -> float:
    """|a - b| / |b|, with 0 against 0."""
    if a == b:
        return 0.0
    return abs(a - b) / abs(b) if b != 0 else float("inf")


def worst_distance(dist: list[float], ref: list[float]) -> float:
    """The worst leaf's distance from the reference, against the reference's
    norm of that leaf or of the median leaf, whichever is larger (NaN reads
    as infinite; no leaves read 0)."""
    if not ref:
        return 0.0
    import statistics

    med = statistics.median(ref)
    worst = 0.0
    for d, r in zip(dist, ref):
        scale = max(r, med)
        gap = d / scale if scale > 0 else d
        worst = max(worst, gap if gap == gap else float("inf"))
    return worst
