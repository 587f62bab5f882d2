"""optimizer.ms_per_step (ms): device time between the CUDA events of the
program's ``optimizer.update`` span (``apply_update``: AdamW leaf by leaf,
the global norm's clipping included), per step."""


def read(ctx):
    try:
        from repro_torch import tracing
    except ImportError:  # a program without the tracer
        return None
    span = tracing.summary()["spans"].get("optimizer.update")
    if span is None or span["device_ms"] is None or ctx.units == 0:
        return None
    return span["device_ms"] / ctx.units
