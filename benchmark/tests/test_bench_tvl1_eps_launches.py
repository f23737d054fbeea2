"""The reader of the epsilon loop's launches per iteration
(``metrics/tvl1_eps_launches_per_iter.py``) on synthetic host events: the
CUDA runtime's launch calls that start inside the "tvl1.eps_loop" ranges,
over the stream synchronisations there (one an iteration)."""

import types

from benchmark.lib.spec import Spec

NAME = "tvl1_eps_launches_per_iter.tvl1"


def _ctx(host):
    return types.SimpleNamespace(trace=types.SimpleNamespace(host=host))


def test_the_reader_counts_launches_over_reads_inside_the_loop_ranges():
    read = Spec().metric_reader(NAME).read
    host = [(0, 100, "tvl1.warp"), (5, 6, "cudaLaunchKernel"),           # in a warp: out
            (100, 200, "tvl1.eps_loop"), (110, 111, "cudaLaunchKernel"),
            (120, 121, "cudaLaunchKernelExC"), (130, 131, "aten::mean"),
            (140, 141, "cudaStreamSynchronize"), (150, 151, "cudaLaunchKernel"),
            (160, 161, "cudaStreamSynchronize"), (199, 200, "cudaLaunchKernel"),
            (200, 201, "cudaLaunchKernel"),                                 # at the end: out
            (300, 400, "tvl1.eps_loop"), (310, 311, "cudaLaunchKernel"),
            (320, 321, "cudaLaunchKernel"), (390, 391, "cudaStreamSynchronize"),
            (500, 600, "tvl1.chain"), (550, 551, "cudaLaunchKernel"),
            (560, 561, "cudaStreamSynchronize")]
    assert read(_ctx(host)) == 6 / 3
    no_launch = [h for h in host if not h[2].startswith("cudaLaunch")]
    assert read(_ctx(no_launch)) == 0.0
    # The CPU: no runtime call at all.
    assert read(_ctx([h for h in no_launch if h[2] != "cudaStreamSynchronize"])) == 0.0
    # Launches and no read (an epsilon of 0): no iteration to divide by.
    assert read(_ctx([h for h in host if h[2] != "cudaStreamSynchronize"])) is None
    assert read(_ctx([h for h in host if h[2] != "tvl1.eps_loop"])) is None
    assert read(types.SimpleNamespace(trace=None)) is None


def test_the_metric_is_declared_for_the_tvl1_cell():
    spec = Spec()
    entry = next(m for m in spec.data["per_layer"] if m["name"] == NAME)
    assert entry["workloads"] == ["tvl1.hd1080_16pairs"]
    assert entry["layer"] == "TV-L1 engine" and entry["moves"] == "recording_frames_per_s"
