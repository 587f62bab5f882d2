"""engine.host_ms_per_run (ms): the host time of the program's
``engine.round`` spans (the event loop's rounds: heap pops, the server's
aggregation and replies, the relaunch's draws, launches and filter) less
the ``sync.*`` spans inside them, the host's waits for the stream; per run."""


def read(ctx):
    try:
        from repro_torch import tracing
    except ImportError:  # a program without the tracer
        return None
    span = tracing.summary()["spans"].get("engine.round")
    if span is None or ctx.units == 0:
        return None
    return (span["host_ms"] - span["wait_ms"]) / ctx.units
