"""One run of one cell: set-up, the measured window, the check, the result.

    python3 benchmark/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Set-up builds or loads the kernels (``build/kernels/`` in the checkout),
renders the cell's recordings from the seed on the card, and runs one
short call of the entry at the cell's shapes.  The window then drives the
entry in a closed loop: one recording (or cohort) after another until
``--seconds`` have passed; the one in progress then runs to its end and
counts.  The rate is the frames of every completed call over the time
from the window's start to the last completion.  With ``--trace 1`` the
first call runs under the profiler and the rest under the program's
``StageTimer``; the result carries the per-layer metrics instead of the
end-to-end ones.  After the window the reference checks a sample of the
answers drawn from the seed (``lib/check.py``).
"""

from __future__ import annotations

import argparse
import gc
import json
import logging
import os
import statistics
import subprocess
import sys
import time

FORBIDDEN = ("jax", "jaxlib", "flax", "btcs_pnes_optical_flow_tpu")
GIB = float(1 << 30)


class Context:
    """What a per-layer metric reader (``metrics/<name>.py``) reads."""

    def __init__(self, spec, timer, frames, items, trace, work, call_s):
        self.spec = spec
        self.metric = None      # the name of the metric being read
        self.times = dict(timer.times) if timer is not None else {}
        self.counts = dict(timer.items) if timer is not None else {}
        self.frames = frames    # frames of the calls the timer saw
        self.items = items      # those calls
        self.trace = trace      # lib.trace.Trace of the profiled call
        self.work = work        # yardstick FlowWork chunks of the profiled call
        self.call_s = call_s    # median wall seconds of those calls (no profiler)

    def stage_seconds(self, name):
        return self.times.get(name)

    def kernel(self, name):
        return self.spec.kernel(name)


def parse(argv):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return ap.parse_args(argv)


def _card_line():
    try:
        return subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                               "--format=csv,noheader"], capture_output=True, text=True,
                              timeout=30).stdout.strip()
    except (OSError, subprocess.SubprocessError):
        return "nvidia-smi unavailable"


def _forbidden_modules():
    return sorted(m for m in sys.modules if m.split(".")[0] in FORBIDDEN)


def drive(entry, seconds, timer=None, traced=None, traced_timer=None):
    """The closed loop of the window: calls of the entry one after another
    until ``seconds`` have passed; the call in progress then runs to its end
    and counts.  With ``traced`` (a dict) one call runs under the profiler
    first, outside the window.  Returns (the completed calls, the seconds
    from the window's start to the last completion, each call's seconds)."""
    from benchmark.lib.trace import profiled

    done, each = [], []
    if traced is not None:
        t = time.perf_counter()
        with profiled(traced):
            done.append(entry.run(0, traced_timer))
        each.append(time.perf_counter() - t)
    t_w = t_end = time.perf_counter()
    while True:
        d = entry.run(len(done), timer)
        done.append(d)
        each.append(time.perf_counter() - t_end)
        t_end = time.perf_counter()
        if t_end - t_w >= seconds:
            return done, t_end - t_w, each


def main(argv=None, *, t0=None, root=None, device=None, out=None, err=None) -> int:
    """Run one cell; returns the exit code.  ``device`` skips the look for
    a card (the CPU tests drive the rest of a run with it)."""
    t0 = time.perf_counter() if t0 is None else t0
    out = out or sys.stdout
    err = err or sys.stderr
    args = parse(argv)

    from benchmark.lib.spec import ROOT, Spec

    root = root or ROOT
    spec = Spec(root)
    wl = spec.workload(args.workload)
    os.environ.setdefault("TORCH_EXTENSIONS_DIR", str(root / "build" / "torch_extensions"))
    os.environ.setdefault("TRITON_CACHE_DIR", str(root / "build" / "triton"))

    import torch

    if device is None:
        have = torch.cuda.device_count() if torch.cuda.is_available() else 0
        if have < wl["chips"]:
            print(f"this cell needs {wl['chips']} CUDA card(s); this machine has {have}",
                  file=err)
            return 3
        device = torch.device("cuda", 0)
    device = torch.device(device)
    cuda = device.type == "cuda"

    from benchmark.lib import calls, check, render

    from btcs_pnes_optical_flow_tpu_torch.utils.timing import StageTimer, logger

    logger.setLevel(logging.WARNING)  # no per-chunk progress lines
    cfg = spec.config(wl["config"])
    traffic = spec.traffic(wl["traffic"])
    limits = spec.limits(wl["name"])

    if cuda:  # build (first run in a checkout) or load the kernels
        from btcs_pnes_optical_flow_tpu_torch.ops import farneback_cuda

        farneback_cuda.library()
    pool = render.render_pool(traffic["render"], traffic["pool"], cfg["height"], cfg["width"],
                              float(cfg["fps"]), args.seed, device)
    entry = calls.make_entry(spec, cfg, traffic, pool, device)
    entry.warm()
    setup_s = time.perf_counter() - t0

    timer = StageTimer(device) if args.trace else None
    traced_timer = StageTimer(device) if args.trace else None
    traced = {} if args.trace else None
    if cuda:
        torch.cuda.reset_peak_memory_stats(device)
    done, window_s, each = drive(entry, args.seconds, timer, traced, traced_timer)
    timed = done[1:] if args.trace else done  # the window's calls
    peak = torch.cuda.max_memory_allocated(device) if cuda else 0
    frames = sum(d.frames for d in timed)
    answers = [a for d in done for a in d.answers]
    for a in answers:
        a.rows = calls.read_rows(a)
    failed = sum(any(r["status"] < 0 for r in a.rows) for a in answers)

    metrics = {}
    dev_info = {"platform": "gpu" if cuda else device.type,
                "kind": torch.cuda.get_device_name(device) if cuda else "cpu",
                "count": int(wl["chips"]), "memory_peak_bytes": int(peak)}
    breakdown = None
    if args.trace:
        tr = traced["trace"]
        ctx = Context(spec, timer, frames, len(timed), tr, entry.work(),
                      statistics.median(each[1:]))
        for m in spec.metrics_of(wl["name"], "per_layer"):
            ctx.metric = m["name"]
            v = spec.metric_reader(m["name"]).read(ctx)
            if v is not None:
                metrics[m["name"]] = {"value": v, "unit": m["unit"]}
        dev_info.update(busy_s=tr.busy_s, window_s=tr.window_s)
        breakdown = {"device_ops": tr.device_ops(), "idle_gaps": tr.idle_by_host()}
    else:
        values = {traffic["rate_metric"]: frames / window_s, "peak_device_gib": peak / GIB,
                  "setup_s": setup_s}
        for m in spec.metrics_of(wl["name"], "end_to_end"):
            metrics[m["name"]] = {"value": values[m["name"]], "unit": m["unit"]}

    # The check, once the program's state is freed (the entry holds only
    # the host's inputs).
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
    t_c = time.perf_counter()
    bases = check.sample_bases(args.seed, [a.base for a in answers], int(traffic["check"]))
    refs = {b: entry.reference(b) for b in bases}
    nums = check.compare([a for a in answers if a.base in refs], refs)
    correct, lines = check.verdict(nums, limits)
    check_s = time.perf_counter() - t_c

    bad = _forbidden_modules()
    if bad:
        print(f"modules of JAX or the JAX package were loaded: {bad}", file=err)
        return 4

    print(f"cell {wl['name']} seed {args.seed}: {len(timed)} calls, {frames} frames in "
          f"{window_s:.4f} s (each call {[round(x, 4) for x in each]} s); set-up "
          f"{setup_s:.4f} s; check {check_s:.4f} s over bases {bases}; "
          f"{_card_line() if cuda else 'cpu'}", file=err)
    if timer is not None:
        print(f"window stages: {timer.report()}", file=err)
    for name, v, lim, good in lines:
        print(f"check {name} {v!r} limit {lim!r} {'ok' if good else 'FAILED'}", file=err)
    err.flush()
    result = {"correct": bool(correct), "attempted": len(answers), "failed": int(failed),
              "metrics": metrics, "device": dev_info}
    if breakdown:
        result["breakdown"] = breakdown
    result["check"] = {name: {"value": v, "limit": lim} for name, v, lim, _ in lines}
    print(json.dumps(result), file=out)
    out.flush()
    return 0
