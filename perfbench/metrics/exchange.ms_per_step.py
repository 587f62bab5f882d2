"""exchange.ms_per_step (ms): device time between CUDA events around each
call of ``core/exchange.py``'s ``exchange_sequential``, less the
``value_and_grad`` spans inside it, per step: the residual updates, the
histogram threshold, the split and the accumulation."""


def read(ctx):
    outer = ctx.spans.get("exchange")
    if not outer or ctx.units == 0:
        return None
    return (sum(outer) - sum(ctx.spans.get("value_and_grad", []))) / ctx.units
