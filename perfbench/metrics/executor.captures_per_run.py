"""executor.captures_per_run (count): the growth of the program's
``executor.STATS["*_traces"]`` over the traced window (graphs captured),
per run; above 0, a run's graph was captured again inside the window."""


def read(ctx):
    try:
        from repro_torch import tracing
    except ImportError:  # a program without the tracer
        return None
    summary = tracing.summary()
    if not summary["spans"] or ctx.units == 0:
        return None
    return sum(v for k, v in summary["executor"].items() if k.endswith("_traces")) / ctx.units
