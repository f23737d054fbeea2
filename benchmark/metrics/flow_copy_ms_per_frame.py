"""Milliseconds per frame of the flow stage's "flow.copy" spans (the
chunk's frames and body axes copied to the card): host time with no
fence, summed by the program's StageTimer over the timed calls, over
their frames."""


def read(ctx):
    s = ctx.stage_seconds("flow.copy")
    return None if s is None or not ctx.frames else 1e3 * s / ctx.frames
