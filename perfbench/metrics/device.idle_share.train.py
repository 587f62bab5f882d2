"""device.idle_share.train (%): the share of the traced window in which no
operation ran on the device (the union of every device operation's
interval, from the profiler's trace), in the training cells."""


def read(ctx):
    if ctx.busy_s <= 0 or ctx.window_s <= 0:
        return None
    return 100.0 * (1.0 - ctx.busy_s / ctx.window_s)
