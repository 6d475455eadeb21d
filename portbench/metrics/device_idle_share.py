"""The device's idle share of the traced window: 1 - (union of the device
operations' intervals) / (window length), from the profiler's trace."""


def read(ctx):
    trace = ctx.get("trace")
    if trace is None or trace.window_s <= 0:
        return None
    return 1.0 - trace.busy_s / trace.window_s
