"""exchange_threshold.roofline (%): the threshold kernels' least time over their device time.

Counted work is what the traffic needs, not the launches the program makes:
a threshold for each participating group (B of K) on each sparse step, T - 1
of every T (the dense sync sends everything, so its thresholds are not
needed), over each leaf of at least ``min_leaf_size`` coordinates
(``perfbench/inputs/weights.py`` ``shapes``: the config's parameter leaves).
Such a call reads each coordinate of its leaf once a pass, max|x| and a
histogram round, and once more with ``refine``: (2 + refine) x 4 B a
coordinate, at the card's HBM peak. The device time is every kernel whose
name holds ``exchange_threshold`` in the traced window.
"""

import math

from perfbench.inputs import weights


def filtered_coordinates(config: dict, exchange: dict) -> int:
    sizes = (math.prod(shape) for shape, _ in weights.shapes(config).values())
    return sum(n for n in sizes if n >= exchange["min_leaf_size"])


def group_step_bytes(config: dict, exchange: dict) -> float:
    """Bytes one needed group's thresholds read in one step, every filtered leaf."""
    passes = 3 if exchange["refine"] else 2
    return 4.0 * passes * filtered_coordinates(config, exchange)


def needed_groups_per_step(exchange: dict) -> float:
    """Participating groups a step, over whole sync periods."""
    T = exchange["sync_period"]
    return exchange["group_size"] * (T - 1) / T


def read(ctx):
    e = ctx.traffic.get("exchange")
    t = ctx.kernel_seconds("exchange_threshold")
    if e is None or t <= 0 or ctx.units == 0:
        return None
    step_bytes = needed_groups_per_step(e) * group_step_bytes(ctx.config, e)
    return 100.0 * ctx.units * step_bytes / ctx.peaks["hbm_bytes_per_s"] / t
