"""The reader of the flow stage's pinned copy share
(``metrics/flow_pinned_copy_share.py``) on synthetic device events: the
device time of the host-to-device copies from pinned memory over that of
every host-to-device copy in the traced window."""

import types

from benchmark.lib.spec import Spec

RECORDING = "flow_pinned_copy_share.recording"
COHORT = "flow_pinned_copy_share.cohort"
PINNED = "Memcpy HtoD (Pinned -> Device)"
PAGEABLE = "Memcpy HtoD (Pageable -> Device)"


def _ctx(dev, lo=0, hi=1000):
    return types.SimpleNamespace(trace=types.SimpleNamespace(dev=dev, lo=lo, hi=hi))


def test_the_reader_takes_pinned_over_all_host_to_device_copy_time():
    read = Spec().metric_reader(RECORDING).read
    dev = [(10, 40, PINNED), (50, 60, PAGEABLE), (70, 80, PINNED),
           (100, 300, "Memcpy DtoH (Device -> Pageable)"),   # to the host: out
           (300, 400, "Memcpy DtoD (Device -> Device)"),      # on the card: out
           (400, 500, "void update_flow_kernel<7, true>"),
           (1000, 1100, PINNED), (-50, -10, PAGEABLE)]        # outside the window: out
    assert read(_ctx(dev)) == 100.0 * 40 / 50
    assert read(_ctx([d for d in dev if d[2] != PAGEABLE])) == 100.0
    assert read(_ctx([d for d in dev if d[2] != PINNED])) == 0.0
    # No host-to-device copy, or none in the window: nothing to divide by.
    assert read(_ctx([d for d in dev if "HtoD" not in d[2]])) is None
    assert read(_ctx(dev, lo=2000, hi=3000)) is None
    assert read(types.SimpleNamespace(trace=None)) is None


def test_both_entries_are_declared_for_their_cells():
    spec = Spec()
    entries = {m["name"]: m for m in spec.data["per_layer"]}
    rec, coh = entries[RECORDING], entries[COHORT]
    assert rec["workloads"] == ["rec1080.arm_2min", "clip480.single_17s",
                                "rec1080.bilateral_2min", "tvl1.hd1080_16pairs"]
    assert rec["layer"] == "flow stage" and rec["moves"] == "recording_frames_per_s"
    assert coh["workloads"] == ["clip480.cohort32_12s"]
    assert coh["layer"] == "cohort runner" and coh["moves"] == "cohort_frames_per_s"
    for m in (rec, coh):
        assert (m["unit"], m["better"], m["source"]) == ("%", "higher", "device_trace")
    assert spec.metric_reader(RECORDING) is spec.metric_reader(COHORT)
