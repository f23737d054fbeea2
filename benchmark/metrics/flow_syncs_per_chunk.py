"""Host syncs per computed chunk of the flow stage, in the profiled call:
the ``cudaStreamSynchronize`` runtime calls of the calling thread that
start inside the program's "flow" range, over the "flow.launch" ranges
(one per chunk computed; in a cohort one per video per chunk).  Every
sync torch makes is one such call (a pageable copy to the card, a read of
a device value); the StageTimer's own fences (``cudaDeviceSynchronize``,
``cudaEventSynchronize``) are other calls and not counted.  0 on the CPU,
where no runtime call is recorded."""

SYNC = "cudaStreamSynchronize"


def read(ctx):
    host = ctx.trace.host if ctx.trace is not None else []
    launches = sum(1 for _, _, n in host if n == "flow.launch")
    if not launches:
        return None
    flows = [(s, e) for s, e, n in host if n == "flow"]
    syncs = sum(1 for s, _, n in host if n == SYNC and any(a <= s < b for a, b in flows))
    return syncs / launches
