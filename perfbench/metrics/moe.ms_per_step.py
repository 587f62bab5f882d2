"""moe.ms_per_step (ms): device time between the CUDA events of the
program's ``moe.route``, ``moe.dispatch``, ``moe.experts`` and
``moe.combine`` spans (``models/moe.py``'s held-experts layer: routing,
the pairs' sort and gather, the grouped products, the combine), summed per
step. On the card each group's loss and gradient replays as a CUDA graph
(``launch/steps.py`` ``GradGraphs``), which opens no span, so this reads the
monitored forward's layers alone; the groups' passes lie in
``grads.ms_per_step``."""

SPANS = ("moe.route", "moe.dispatch", "moe.experts", "moe.combine")


def read(ctx):
    try:
        from repro_torch import tracing
    except ImportError:  # a program without the tracer
        return None
    spans = tracing.summary()["spans"]
    ms = [spans[n]["device_ms"] for n in SPANS if n in spans]
    if not ms or None in ms or ctx.units == 0:
        return None
    return sum(ms) / ctx.units
