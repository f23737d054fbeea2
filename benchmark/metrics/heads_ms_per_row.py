"""Milliseconds of the PC1 and metric heads per cohort row: the program's
StageTimer "pc1" and "metrics" stages over the rows they served."""


def read(ctx):
    s = [ctx.stage_seconds(k) for k in ("pc1", "metrics")]
    rows = ctx.counts.get("pc1", 0)
    return None if None in s or not rows else 1e3 * sum(s) / rows
