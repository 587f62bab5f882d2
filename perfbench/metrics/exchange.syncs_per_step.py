"""exchange.syncs_per_step (count): the host's waits for the stream per
train step, as the program's ``sync.*`` spans count them: each histogram
round's ``torch.bincount`` (two: its input's minimum and maximum) and its copy
of a constant to the device, and each attention layer's copy of its scale
(the monitored forward, each group's forward and its recompute)."""


def read(ctx):
    try:
        from repro_torch import tracing
    except ImportError:  # a program without the tracer
        return None
    spans = tracing.summary()["spans"]
    if not spans or ctx.units == 0:
        return None
    return sum(s["syncs"] for name, s in spans.items() if name.startswith("sync.")) / ctx.units
