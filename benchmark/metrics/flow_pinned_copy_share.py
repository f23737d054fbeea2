"""The share of the profiled call's host-to-device copy time that copied
from page-locked host memory, in %: the device time of its ``Memcpy HtoD``
operations whose name says ``Pinned`` (the profiler names them ``Memcpy
HtoD (Pinned -> Device)``) over that of all its ``Memcpy HtoD``
operations.  It reads how much of the frames' and axes' traffic the flow
stage stages in pinned memory, where the copy is queued without a host
sync; a pageable copy (``Memcpy HtoD (Pageable -> Device)``) synchronises
the stream first.  None without a host-to-device copy."""

HTOD = "Memcpy HtoD"
PINNED = "Pinned"


def read(ctx):
    tr = ctx.trace
    if tr is None:
        return None
    copies = [(e - s, n) for s, e, n in tr.dev if HTOD in n and tr.lo <= s < tr.hi]
    total = sum(d for d, _ in copies)
    if not total:
        return None
    return 100.0 * sum(d for d, n in copies if PINNED in n) / total
