"""The share of a call in which no kernel, copy or memset ran on the
device, in %: the profiled call's busy device seconds over the median
wall seconds of the window's calls, which run the same shapes without the
profiler (the profiler slows the host, not the device)."""


def read(ctx):
    tr = ctx.trace
    return None if tr is None or not ctx.call_s else 100.0 * (1.0 - tr.busy_s / ctx.call_s)
