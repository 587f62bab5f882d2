"""frontend.ms_per_step (ms): device time between the CUDA events of the
program's ``audio.frontend`` span (``models/audio.py`` ``embed_frames``: the
conv feature encoder, the feature norm, the projection and the mask
embedding), per train step. Forward only: the monitored forward and each
group's; their backward lies in ``grads.ms_per_step``."""


def read(ctx):
    try:
        from repro_torch import tracing
    except ImportError:  # a program without the tracer
        return None
    span = tracing.summary()["spans"].get("audio.frontend")
    if span is None or span["device_ms"] is None or ctx.units == 0:
        return None
    return span["device_ms"] / ctx.units
