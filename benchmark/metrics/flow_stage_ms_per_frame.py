"""Milliseconds of the flow stage per frame: the program's StageTimer
"flow" stage (fenced by CUDA events) over the frames of the timed calls."""


def read(ctx):
    s = ctx.stage_seconds("flow")
    return None if s is None or not ctx.frames else 1e3 * s / ctx.frames
