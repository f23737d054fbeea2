"""Milliseconds of the metric head per recording: the program's StageTimer
"metrics" stage over the timed calls."""


def read(ctx):
    s = ctx.stage_seconds("metrics")
    return None if s is None or not ctx.items else 1e3 * s / ctx.items
