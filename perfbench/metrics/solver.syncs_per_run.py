"""solver.syncs_per_run (count): the host's waits for the stream per run, as
the program's ``sync.*`` spans count them (one a call, two for a call that
waits twice): reads to the host and copies from pageable host memory, in
set-up, rounds, certificates and result."""


def read(ctx):
    try:
        from repro_torch import tracing
    except ImportError:  # a program without the tracer
        return None
    spans = tracing.summary()["spans"]
    if not spans or ctx.units == 0:
        return None
    return sum(s["syncs"] for name, s in spans.items() if name.startswith("sync.")) / ctx.units
