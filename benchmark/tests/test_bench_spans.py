"""The readers of the flow stage's spans and host syncs
(``metrics/flow_*_ms_per_frame.py``, ``metrics/flow_syncs_per_chunk.py``):
present and finite in a traced CPU run of the tiny cells, the program's
ranges on the host's side of a trace and never among its device
operations, and, on a card (marked ``cuda``, skipped without one), one
``cudaStreamSynchronize`` for each pageable copy to the card and each read
of a device value in a 1080p chunk."""

import io
import json
import math
import types

import numpy as np
import pytest

from benchmark.lib import harness
from benchmark.lib.spec import Spec
from benchmark.lib.trace import profiled

SYNC = "cudaStreamSynchronize"
SPANS = ("flow.decode_wait", "flow.copy", "flow.launch", "flow.readback", "flow.store")
RANGES = ("flow", "pc1", "metrics") + SPANS
NEW = {
    "tiny.rec": [f"flow_{k}_ms_per_frame.recording"
                 for k in ("decode_wait", "copy", "launch", "readback", "store")]
    + ["flow_syncs_per_chunk.recording"],
    "tiny.coh": [f"flow_{k}_ms_per_frame.cohort" for k in ("copy", "launch", "readback")]
    + ["flow_syncs_per_chunk.cohort"],
}


def _run(root, cell):
    out, err = io.StringIO(), io.StringIO()
    rc = harness.main(["--workload", cell, "--seed", str(2**31 + 11), "--seconds", "0",
                       "--trace", "1"], root=root, device="cpu", out=out, err=err)
    assert rc == 0, err.getvalue()[-2000:]
    return json.loads(out.getvalue().splitlines()[-1])


@pytest.mark.parametrize("cell", sorted(NEW))
def test_every_new_metric_is_read_in_a_traced_run(tiny_root, cell):
    res = _run(tiny_root, cell)
    for name in NEW[cell]:
        assert name in res["metrics"], name
        assert math.isfinite(res["metrics"][name]["value"]), name
    syncs = [v["value"] for k, v in res["metrics"].items() if k.startswith("flow_syncs")]
    assert syncs == [0.0]  # no CUDA runtime call on the CPU


def _ctx(host):
    return types.SimpleNamespace(trace=types.SimpleNamespace(host=host))


def test_the_syncs_reader_counts_stream_syncs_inside_the_flow_range():
    read = Spec().metric_reader("flow_syncs_per_chunk.recording").read
    host = [(0, 100, "flow"), (1, 2, "cudaDeviceSynchronize"), (10, 20, "flow.launch"),
            (30, 40, "flow.launch"), (12, 13, SYNC), (32, 33, SYNC), (50, 51, SYNC),
            (99, 100, "cudaEventSynchronize"), (120, 121, SYNC), (110, 130, "pc1")]
    assert read(_ctx(host)) == 1.5
    assert read(_ctx([h for h in host if h[2] != "flow.launch"])) is None
    assert read(types.SimpleNamespace(trace=None)) is None


def test_program_ranges_are_host_events_and_no_device_operation():
    """A profiled CPU ``run_full`` with a timer carries every range on the
    host's side of the trace (the card case below checks the device's)."""
    from btcs_pnes_optical_flow_tpu_torch.dataio.video import ArraySource
    from btcs_pnes_optical_flow_tpu_torch.models.pipeline import run_full
    from btcs_pnes_optical_flow_tpu_torch.utils.timing import StageTimer

    from benchmark.lib import calls

    rng = np.random.default_rng(5)
    clip = rng.integers(0, 255, (40, 48, 64), dtype=np.uint8)
    roi = [np.array([[8.0, 8.0], [56.0, 8.0], [56.0, 40.0], [8.0, 40.0]])]
    out = {}
    with profiled(out):
        run_full(ArraySource(clip, fps=30.0), calls.skeleton(40, 30.0, 0.3), roi,
                 calls.pipeline_config({}), 16, checkpoint_dir=None, device="cpu",
                 timer=StageTimer("cpu"))
    tr = out["trace"]
    names = {n for _, _, n in tr.host}
    assert set(RANGES) - {"flow.store"} <= names
    assert not {n for _, _, n in tr.dev} & set(RANGES)


@pytest.fixture()
def card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card")


@pytest.mark.cuda
def test_each_copy_and_read_syncs_once_on_the_card(card):
    """A two-chunk 1080p ``run_full`` under ``rec1080.arm_2min``'s settings:
    in each copy span the three pageable copies to the card, in each
    read-back span the three ``.cpu()`` reads (``aten::copy_``) and the
    ``int()`` of the clip count (``aten::_local_scalar_dense``) hold one
    ``cudaStreamSynchronize`` each, and no other sync falls in those spans;
    no program range is among the device operations."""
    import torch

    from btcs_pnes_optical_flow_tpu_torch.models.pipeline import run_full
    from btcs_pnes_optical_flow_tpu_torch.ops import farneback_cuda
    from btcs_pnes_optical_flow_tpu_torch.utils.timing import StageTimer

    from benchmark.lib import calls, render

    spec = Spec()
    cfg, traffic = spec.config("rec1080"), spec.traffic("arm_2min")
    dev, fps, n = torch.device("cuda", 0), float(cfg["fps"]), 129
    farneback_cuda.library()
    pool = render.render_pool(traffic["render"], 1, cfg["height"], cfg["width"], fps,
                              2**31 + 7, dev)
    rois = [np.asarray(p, np.float64) for p in traffic["rois"]]

    def call(timer):
        src = calls.played_source(pool[0], traffic["playback"], n, fps)
        return run_full(src, calls.skeleton(n, fps, traffic["theta"]), rois,
                        calls.pipeline_config(cfg), 64, device=dev, timer=timer)

    call(None)
    out = {}
    with profiled(out):
        call(StageTimer(dev))
    tr = out["trace"]
    host = sorted(tr.host, key=lambda h: (h[0], -h[1]))
    launches = [h for h in host if h[2] == "flow.launch"]
    assert len(launches) == 2
    for span, want in (("flow.copy", {"aten::copy_": 3}),
                       ("flow.readback", {"aten::copy_": 3, "aten::_local_scalar_dense": 1})):
        for a, b, _ in (h for h in host if h[2] == span):
            syncs = [s for s, _, n in host if n == SYNC and a <= s < b]
            holders = [_innermost_op(host, s) for s in syncs]
            assert len(set(holders)) == len(syncs), span  # one sync an operation
            got = {}
            for _, _, name in holders:
                got[name] = got.get(name, 0) + 1
            assert got == want, (span, got)
    names = {n for _, _, n in tr.dev} | {n for n, _ in tr.device_ops(top=10**6)}
    assert not {n for n in names if n in RANGES or n.startswith("flow.")}


def _innermost_op(host, t):
    """The innermost aten operation of ``host`` (sorted by start) running at ``t``."""
    ops = [h for h in host if h[2].startswith("aten::") and h[0] <= t < h[1]]
    return ops[-1] if ops else (t, t, "no operation")
