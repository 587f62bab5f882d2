"""eval.ms_per_run (ms): device time between the CUDA events of the
program's ``engine.eval`` span (the batched certificates of every eval
boundary: two float32 GEMMs over X, then their reads to the host), per run."""


def read(ctx):
    try:
        from repro_torch import tracing
    except ImportError:  # a program without the tracer
        return None
    span = tracing.summary()["spans"].get("engine.eval")
    if span is None or span["device_ms"] is None or ctx.units == 0:
        return None
    return span["device_ms"] / ctx.units
