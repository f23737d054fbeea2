"""Milliseconds per frame of the flow stage's "flow.store" spans (writing
the chunk to the checkpoint store): host time with no fence, summed by
the program's StageTimer over the timed calls, over their frames."""


def read(ctx):
    s = ctx.stage_seconds("flow.store")
    return None if s is None or not ctx.frames else 1e3 * s / ctx.frames
