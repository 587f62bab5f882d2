"""sdca_inner.launches_per_run (count): the growth of the program's
``ops.LAUNCHES["sdca_inner"]`` over the traced window, per run (a graph
replay adds the launches it holds). ``LAUNCHES`` counts launches on the
card only, so a CPU run reads 0."""


def read(ctx):
    try:
        from repro_torch import tracing
    except ImportError:  # a program without the tracer
        return None
    summary = tracing.summary()
    if not summary["spans"] or ctx.units == 0:
        return None
    return sum(v for k, v in summary["launches"].items() if k == "sdca_inner") / ctx.units
