"""moe_threshold.roofline (%): the exchange's threshold kernels' least time
over their device time, in the Qwen3-MoE cell.

``exchange_threshold.roofline``'s count with the MoE share's parameter
leaves (``perfbench/inputs/moe_weights.py`` ``shapes``: the held experts,
the router, the vocabulary slice) in place of the dense decoder's: a
threshold for each participating group (B of K) on each sparse step, T - 1
of every T, over each leaf of at least ``min_leaf_size`` coordinates; a call
reads each coordinate once a pass, max|x| and a histogram round, and once
more with ``refine``: (2 + refine) x 4 B a coordinate, at the card's HBM
peak. The device time is every kernel whose name holds
``exchange_threshold`` in the traced window.
"""

import math

from perfbench.inputs import moe_weights


def filtered_coordinates(config: dict, exchange: dict) -> int:
    sizes = (math.prod(shape) for shape, _ in moe_weights.shapes(config).values())
    return sum(n for n in sizes if n >= exchange["min_leaf_size"])


def step_bytes(config: dict, exchange: dict) -> float:
    """Bytes the needed thresholds of one step read, over whole sync periods."""
    T, passes = exchange["sync_period"], 3 if exchange["refine"] else 2
    groups = exchange["group_size"] * (T - 1) / T
    return groups * 4.0 * passes * filtered_coordinates(config, exchange)


def read(ctx):
    e = ctx.traffic.get("exchange")
    t = ctx.kernel_seconds("exchange_threshold")
    if e is None or t <= 0 or ctx.units == 0:
        return None
    return 100.0 * ctx.units * step_bytes(ctx.config, e) / ctx.peaks["hbm_bytes_per_s"] / t
