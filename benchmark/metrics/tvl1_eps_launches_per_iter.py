"""Kernel launches per iteration of TV-L1's epsilon loop, in the profiled
call: the CUDA runtime launch calls (host events whose name starts with
``cudaLaunch``) of the calling thread that start inside the program's
"tvl1.eps_loop" ranges, over the ``cudaStreamSynchronize`` calls in those
ranges (one an iteration: the loop reads whether any pair still iterates).
It reads whether an iteration runs as one fused step and its stop test or
as some ninety tensor operations.  0 on the CPU, where no runtime call is
recorded; None without such a range, or with launches and no read."""

LAUNCH = "cudaLaunch"
SYNC = "cudaStreamSynchronize"


def read(ctx):
    host = ctx.trace.host if ctx.trace is not None else []
    loops = [(s, e) for s, e, n in host if n == "tvl1.eps_loop"]
    if not loops:
        return None
    inside = [n for s, _, n in host if any(a <= s < b for a, b in loops)]
    launches = sum(1 for n in inside if n.startswith(LAUNCH))
    syncs = sum(1 for n in inside if n == SYNC)
    if not syncs:
        return None if launches else 0.0
    return launches / syncs
