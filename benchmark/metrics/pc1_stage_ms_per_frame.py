"""Milliseconds of the PC1 head per frame: the program's StageTimer "pc1"
stage over the frames of the timed calls."""


def read(ctx):
    s = ctx.stage_seconds("pc1")
    return None if s is None or not ctx.frames else 1e3 * s / ctx.frames
