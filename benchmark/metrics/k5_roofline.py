"""K5's share of its roofline in the TV-L1 cells, in %: the bound of the
profiled call's K5 work (``kernels/k5.py``: n_warps launches a level over
every level's whole frame, real pairs only; the larger of bytes over the
HBM rate and operations over the float32 rate, ``lib/yardstick.py``'s
peaks) over the device time of its launches in the trace.  None where the
call's work is not TV-L1's or the trace holds no K5 launch."""

from benchmark.lib.yardstick import FP32_OPS_PER_S, HBM_BYTES_PER_S


def read(ctx):
    k5 = ctx.kernel("k5")
    work = [w for w in ctx.work if hasattr(w, "n_warps")]
    secs, n = ctx.trace.kernel_seconds(k5.PATTERN) if ctx.trace is not None else (0.0, 0)
    if not work or not n or secs <= 0:
        return None
    bound = 0.0
    for w in work:
        for h, wd, _ in w.levels:
            nbytes, ops = k5.launch(w.pairs * h * wd)
            bound += w.n_warps * max(nbytes / HBM_BYTES_PER_S, ops / FP32_OPS_PER_S)
    return 100.0 * bound / secs
