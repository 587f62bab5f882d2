"""exchange.threshold_ms_per_step (ms): device time between the CUDA events
of the program's ``exchange.threshold`` spans (``threshold_for_topk``: both
histogram rounds of one leaf and group, their ``torch.bincount`` included),
summed per step."""


def read(ctx):
    try:
        from repro_torch import tracing
    except ImportError:  # a program without the tracer
        return None
    span = tracing.summary()["spans"].get("exchange.threshold")
    if span is None or span["device_ms"] is None or ctx.units == 0:
        return None
    return span["device_ms"] / ctx.units
