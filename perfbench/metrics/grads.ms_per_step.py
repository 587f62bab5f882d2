"""grads.ms_per_step (ms): device time between CUDA events that the traced
run records around each call of ``launch/steps.py``'s ``value_and_grad``
(the models' forward and backward), summed per step."""


def read(ctx):
    spans = ctx.spans.get("value_and_grad")
    if not spans or ctx.units == 0:
        return None
    return sum(spans) / ctx.units
