"""Where the flow stage's host syncs are, and what its spans cost, on one card.

    python3 scripts/flow_span_cost.py [--pairs 6] [--seed N]   # repository root, one CUDA card

At the benchmark cell ``rec1080.arm_2min``'s settings (``benchmark/configs/
rec1080.json``, ``benchmark/traffic/arm_2min.json``: 1080p recordings of
3601 frames played from memory, one arm ROI, 64-pair chunks, a checkpoint
store), driven through the benchmark's own entry (``benchmark/entries/
run_full.py``):

1. sync sites: a two-chunk recording through ``run_full`` with a
   ``StageTimer`` under ``torch.cuda.set_sync_debug_mode("warn")``; every
   sync it warns of is put down to the stage or span open at the time
   (``flow.*``, ``flow``, ``pc1``, ``metrics``) and to the innermost line
   of the package on the Python stack, and counted per chunk (the timer's
   own fences show as lines of ``utils/timing.py``);
2. the spans' on-cost: whole recordings through ``run_full`` with a
   ``StageTimer``, in turns (on, off, off, on, ...) with the spans on and
   with ``utils.timing.span`` replaced by one that returns a
   ``nullcontext`` (off): each call's flow stage in ms/frame and its
   seconds, and the medians of each side;
3. one span's host cost: 20000 empty spans on one timer, in µs each, and
   that times the spans of one recording, per frame.

Prints one JSON line per part, after the card's name and power limit.
"""

from __future__ import annotations

import argparse
import collections
import contextlib
import json
import pathlib
import statistics
import subprocess
import sys
import time
import traceback
import warnings

import torch

ROOT = pathlib.Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

from benchmark.lib import calls, render  # noqa: E402
from benchmark.lib.spec import Spec  # noqa: E402
from btcs_pnes_optical_flow_tpu_torch.ops import farneback_cuda  # noqa: E402
from btcs_pnes_optical_flow_tpu_torch.utils import timing  # noqa: E402
from btcs_pnes_optical_flow_tpu_torch.utils.timing import StageTimer, logger  # noqa: E402

PACKAGE = "btcs_pnes_optical_flow_tpu_torch/"


def _entry(seed: int, device):
    spec = Spec(ROOT)
    cfg, traffic = spec.config("rec1080"), spec.traffic("arm_2min")
    pool = render.render_pool(traffic["render"], traffic["pool"], cfg["height"], cfg["width"],
                              float(cfg["fps"]), seed, device)
    entry = calls.make_entry(spec, cfg, traffic, pool, device)
    entry.warm()
    return entry


def sync_sites(entry, n_frames: int) -> dict:
    """Each host sync of one call with a timer, caught by torch.cuda's sync
    debug mode, by the stage or span open at the time and the innermost
    line of the package on the stack."""
    sites = collections.Counter()
    open_ranges = []
    real_span, real_timed = StageTimer.span, StageTimer.timed

    def tracked(real):
        @contextlib.contextmanager
        def ranged(self, name, *args):
            open_ranges.append(name)
            try:
                with real(self, name, *args):
                    yield
            finally:
                open_ranges.pop()
        return ranged

    def hook(message, category, filename, lineno, file=None, line=None):
        here = [f for f in traceback.extract_stack() if PACKAGE in f.filename]
        site = (f"{here[-1].filename[here[-1].filename.find(PACKAGE):]}:{here[-1].lineno}"
                if here else f"{filename}:{lineno}")
        sites[(open_ranges[-1] if open_ranges else "-", site)] += 1

    timer = StageTimer(entry.device)
    with warnings.catch_warnings():
        warnings.simplefilter("always")
        warnings.showwarning = hook
        StageTimer.span, StageTimer.timed = tracked(real_span), tracked(real_timed)
        torch.cuda.set_sync_debug_mode("warn")
        try:
            entry._call(0, n_frames, timer)
        finally:
            torch.cuda.set_sync_debug_mode(0)
            StageTimer.span, StageTimer.timed = real_span, real_timed
    chunks = timer.items.get("flow.launch", 0)
    in_flow = sum(c for (r, _), c in sites.items() if r.startswith("flow"))
    return {"part": "sync_sites", "frames": n_frames, "chunks": chunks,
            "syncs_in_flow_per_chunk": in_flow / chunks if chunks else None,
            "sites": [{"range": r, "site": site, "count": c,
                       "per_chunk": c / chunks if chunks else None}
                      for (r, site), c in sorted(sites.items(), key=lambda x: (x[0][0], -x[1]))]}


def _off(timer, name):
    return contextlib.nullcontext()


def on_cost(entry, pairs: int) -> dict:
    real = timing.span
    rows = []
    try:
        for k in range(pairs):
            for mode in (("on", "off") if k % 2 == 0 else ("off", "on")):
                timing.span = real if mode == "on" else _off
                timer = StageTimer(entry.device)
                t = time.perf_counter()
                entry.run(k, timer)
                rows.append({"mode": mode, "call_s": time.perf_counter() - t,
                             "flow_ms_per_frame": 1e3 * timer.times["flow"] / entry.n,
                             "spans": sum(v for key, v in timer.items.items()
                                          if key.startswith("flow."))})
    finally:
        timing.span = real
    med = {m: {key: statistics.median(r[key] for r in rows if r["mode"] == m)
               for key in ("call_s", "flow_ms_per_frame")} for m in ("on", "off")}
    return {"part": "on_cost", "frames": entry.n, "calls": rows, "median": med,
            "on_minus_off_pct_of_flow": 100.0 * (med["on"]["flow_ms_per_frame"]
                                                 - med["off"]["flow_ms_per_frame"])
            / med["off"]["flow_ms_per_frame"]}


def span_cost(entry, spans_per_recording: int, n: int = 20000) -> dict:
    timer = StageTimer(entry.device)
    t = time.perf_counter()
    for _ in range(n):
        with timing.span(timer, "flow.copy"):
            pass
    us = 1e6 * (time.perf_counter() - t) / n
    ms_per_frame = 1e-3 * us * spans_per_recording / entry.n
    return {"part": "span_cost", "us_per_span": us, "spans_per_recording": spans_per_recording,
            "ms_per_frame": ms_per_frame}


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--pairs", type=int, default=6)
    ap.add_argument("--seed", type=int, default=2**31 + 1501)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        sys.exit("needs an NVIDIA card")
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip(), flush=True)
    logger.setLevel("WARNING")
    device = torch.device("cuda", 0)
    farneback_cuda.library()
    entry = _entry(args.seed, device)
    print(json.dumps(sync_sites(entry, 2 * entry.chunk + 1)), flush=True)
    cost = on_cost(entry, args.pairs)
    print(json.dumps(cost), flush=True)
    spans = max(r["spans"] for r in cost["calls"])
    print(json.dumps(span_cost(entry, spans)), flush=True)


if __name__ == "__main__":
    main()
