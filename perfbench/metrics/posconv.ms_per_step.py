"""posconv.ms_per_step (ms): device time between the CUDA events of the
program's ``audio.posconv`` span (``models/audio.py`` ``pos_conv``: the
weight norm and the grouped 128-tap convolution over positions), per train
step. Forward only, as ``frontend.ms_per_step``."""


def read(ctx):
    try:
        from repro_torch import tracing
    except ImportError:  # a program without the tracer
        return None
    span = tracing.summary()["spans"].get("audio.posconv")
    if span is None or span["device_ms"] is None or ctx.units == 0:
        return None
    return span["device_ms"] / ctx.units
