"""solver.norms_sq.ms_per_run (ms): device time between the CUDA events of
the program's ``solver.norms_sq`` span (every row's squared norm: the
``X*X`` temporary and its sum, rebuilt by each ``Session``), per run."""


def read(ctx):
    try:
        from repro_torch import tracing
    except ImportError:  # a program without the tracer
        return None
    span = tracing.summary()["spans"].get("solver.norms_sq")
    if span is None or span["device_ms"] is None or ctx.units == 0:
        return None
    return span["device_ms"] / ctx.units
