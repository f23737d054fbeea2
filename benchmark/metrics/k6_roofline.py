"""K6's share of its roofline in the TV-L1 cells, in %: the bound of the
profiled call's K6 work (``kernels/k6.py``: a chain of n_iterations per
warp on each fixed-length level, real pairs only; the larger of bytes over
the HBM rate and operations over the float32 rate, ``lib/yardstick.py``'s
peaks) over the device time of its launches in the trace.  None where the
call's work is not TV-L1's or the trace holds no K6 launch."""

from benchmark.lib.yardstick import FP32_OPS_PER_S, HBM_BYTES_PER_S


def read(ctx):
    k6 = ctx.kernel("k6")
    work = [w for w in ctx.work if hasattr(w, "n_warps")]
    secs, n = ctx.trace.kernel_seconds(k6.PATTERN) if ctx.trace is not None else (0.0, 0)
    if not work or not n or secs <= 0:
        return None
    bound = 0.0
    for w in work:
        for h, wd, fixed in w.levels:
            if fixed:
                nbytes, ops = k6.chain(w.pairs * h * wd, w.n_iterations)
                bound += w.n_warps * max(nbytes / HBM_BYTES_PER_S, ops / FP32_OPS_PER_S)
    return 100.0 * bound / secs
