"""The reader of the PC1 head's launches (``metrics/pc1_launches_per_call.py``):
on a synthetic trace it counts the CUDA runtime's launch calls that start
inside the "pc1" ranges, over those ranges; in a traced CPU run of the
tiny cells it reads 0 (no runtime call is recorded on the CPU)."""

import io
import json
import types

import pytest

from benchmark.lib import harness
from benchmark.lib.spec import Spec

NAMES = {"tiny.rec": "pc1_launches_per_call.recording",
         "tiny.coh": "pc1_launches_per_call.cohort"}


def _ctx(host):
    return types.SimpleNamespace(trace=types.SimpleNamespace(host=host))


@pytest.mark.parametrize("name", sorted(NAMES.values()))
def test_the_reader_counts_launches_inside_the_pc1_ranges(name):
    read = Spec().metric_reader(name).read
    host = [(0, 100, "flow"), (5, 6, "cudaLaunchKernel"),            # in flow: not counted
            (100, 200, "pc1"), (110, 111, "cudaLaunchKernel"), (120, 121, "cudaLaunchKernelExC"),
            (130, 131, "aten::mul"), (140, 141, "cudaStreamSynchronize"),
            (199, 200, "cudaLaunchKernel"), (200, 201, "cudaLaunchKernel"),  # at the end: out
            (300, 400, "pc1"), (350, 351, "cudaLaunchKernel"), (500, 600, "metrics"),
            (550, 551, "cudaLaunchKernel")]
    assert read(_ctx(host)) == 2.0
    assert read(_ctx([h for h in host if not h[2].startswith("cudaLaunch")])) == 0.0
    assert read(_ctx([h for h in host if h[2] != "pc1"])) is None
    assert read(types.SimpleNamespace(trace=None)) is None


@pytest.mark.parametrize("cell", sorted(NAMES))
def test_the_metric_is_read_in_a_traced_run(tiny_root, cell):
    out, err = io.StringIO(), io.StringIO()
    rc = harness.main(["--workload", cell, "--seed", str(2**31 + 13), "--seconds", "0",
                       "--trace", "1"], root=tiny_root, device="cpu", out=out, err=err)
    assert rc == 0, err.getvalue()[-2000:]
    res = json.loads(out.getvalue().splitlines()[-1])
    assert res["metrics"][NAMES[cell]] == {"value": 0.0, "unit": "launches/call"}
