"""moe_experts.roofline (%): the held experts' grouped products' least time
over their device time, every pass of the traced steps.

Counted work (``step_flops``): 2 x d_model x the expert width FLOPs a held
(token, choice) row and product, over the rows that the traffic routes to
the held experts of a layer on average (tokens x top-k x held / total), in
every layer; per step 3 products of an exchanging step's monitored forward
and, over the groups' passes, 3 of the forward, 3 of remat's recompute
(with ``remat``) and 6 of the backward (the input's and the weights'
gradients of each), at the card's bf16 peak. The device time is that of
every CUTLASS grouped GEMM (``torch._grouped_mm``'s kernels on the card,
whose names hold ``GroupProblemShape``) in the traced window, the graphed
passes' included. Rows are the traffic's mean, not the routed count: a
router that sends the held experts fewer rows than their share reads high,
more reads low.
"""

from perfbench.inputs.moe_weights import held as _held

KERNELS = ("GroupProblemShape",)


def held_rows(config: dict, traffic: dict) -> float:
    """Held (token, choice) rows of one layer's pass over the whole batch."""
    return (traffic["batch"] * traffic["seq"] * config["num_experts_per_tok"]
            * _held(config)[0] / config["num_experts"])


def products_per_row(traffic: dict) -> int:
    """Grouped products a held row takes in one step: the exchanging step's
    monitored forward, then the forward, remat's recompute and backward."""
    monitored = 3 if traffic.get("exchange") is not None else 0
    return monitored + 3 + (3 if traffic["remat"] else 0) + 6


def step_flops(config: dict, traffic: dict) -> float:
    return (2.0 * config["hidden_size"] * config["moe_intermediate_size"]
            * held_rows(config, traffic) * products_per_row(traffic)
            * config["num_hidden_layers"])


def read(ctx):
    t = ctx.kernel_seconds(*KERNELS)
    if t <= 0 or ctx.units == 0:
        return None
    return 100.0 * ctx.units * step_flops(ctx.config, ctx.traffic) / ctx.peaks["bfloat16_flops"] / t
