"""Milliseconds per frame of the flow stage's "flow.readback" spans (the
clip count, the feature reads and the NaN mask of a finished chunk):
host time with no fence, summed by the program's StageTimer over the
timed calls, over their frames."""


def read(ctx):
    s = ctx.stage_seconds("flow.readback")
    return None if s is None or not ctx.frames else 1e3 * s / ctx.frames
