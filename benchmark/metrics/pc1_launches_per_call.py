"""Kernel launches per call of the PC1 head, in the profiled call: the CUDA
runtime launch calls (host events whose name starts with ``cudaLaunch``)
of the calling thread that start inside the program's "pc1" ranges, over
the number of those ranges (one per recording in ``run_full``, one per
cohort in ``run_cohort``).  It reads whether the band-pass runs as a few
kernels or as a loop of tensor steps per sample.  0 on the CPU, where no
runtime call is recorded; nothing without a "pc1" range."""

LAUNCH = "cudaLaunch"


def read(ctx):
    host = ctx.trace.host if ctx.trace is not None else []
    ranges = [(s, e) for s, e, n in host if n == "pc1"]
    if not ranges:
        return None
    launches = sum(1 for s, _, n in host
                   if n.startswith(LAUNCH) and any(a <= s < b for a, b in ranges))
    return launches / len(ranges)
