"""Iterations of TV-L1's epsilon loop per warp, in the profiled call: the
``cudaStreamSynchronize`` runtime calls of the calling thread that start
inside the program's "tvl1.eps_loop" ranges, over the number of those
ranges (one a call of the loop, i.e. one a warp on a level that runs it).
The loop reads one device value an iteration (whether any pair is still
iterating), and each read is one such call.  0 on the CPU, where no
runtime call is recorded; None without such a range."""

SYNC = "cudaStreamSynchronize"


def read(ctx):
    host = ctx.trace.host if ctx.trace is not None else []
    loops = [(s, e) for s, e, n in host if n == "tvl1.eps_loop"]
    if not loops:
        return None
    syncs = sum(1 for s, _, n in host if n == SYNC and any(a <= s < b for a, b in loops))
    return syncs / len(loops)
