"""A kernel's share of its roofline, in %, for the metrics named
``<kernel>_roofline`` (any cell suffix): the bound of the work the
profiled call's inputs need (``kernels/<kernel>.py`` over the ROI boxes,
iterations and pairs) over the device time of its launches in the trace."""

from benchmark.lib.yardstick import roofline_pct

SUFFIX = "_roofline"


def read(ctx):
    base = ctx.metric.split(".")[0]
    return roofline_pct(ctx.kernel(base[:-len(SUFFIX)]), ctx.work, ctx.trace)
