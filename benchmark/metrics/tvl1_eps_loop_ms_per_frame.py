"""Milliseconds per frame of TV-L1's epsilon loop in the profiled call:
the host time of the program's "tvl1.eps_loop" ranges (one a call of the
loop, ``ops/tvl1.py``) over the call's frames.  The loop reads a device
value each iteration, so its first read also waits for the warp enqueued
just before it (K5 and the linearisation): the range holds that drain.
None without such a range."""


def read(ctx):
    host = ctx.trace.host if ctx.trace is not None else []
    secs = sum(e - s for s, e, n in host if n == "tvl1.eps_loop") / 1e9
    if not secs or not ctx.items:
        return None
    return 1e3 * secs / (ctx.frames / ctx.items)
