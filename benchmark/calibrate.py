"""Readings that the limits of a cell's check are set from.

    python3 benchmark/calibrate.py --workload <cell> --seeds 1,2,... \
        --control-seeds 7,8,9 [--out readings.jsonl]

In one process on the card: for each seed, the cell's inputs from that
seed, the first call of the cell's entry (one recording; a cohort cell:
one cohort), and the check's numbers against the reference over a seeded
sample of the bases that call answers, as a run samples them
(``kind: "program"``); for each control seed, the
reference computed in bfloat16 put in the program's place
(``kind: "control"``).  The lower reading of a number is the largest of
the program's, the upper the smallest of the control's.  The benchmark's
runs never run this.
"""

import argparse
import contextlib
import json
import pathlib
import sys
import time

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parents[1]))


def readings(workload, seeds, control_seeds, device=None, root=None, emit=print):
    import torch

    from benchmark.lib import calls, check, render
    from benchmark.lib.spec import ROOT, Spec
    from btcs_pnes_optical_flow_tpu_torch.utils.timing import logger

    logger.setLevel("WARNING")
    spec = Spec(root or ROOT)
    wl = spec.workload(workload)
    cfg, traffic = spec.config(wl["config"]), spec.traffic(wl["traffic"])
    device = torch.device(device or "cuda")
    out = []

    for kind, seed_list in (("program", seeds), ("control", control_seeds)):
        for seed in seed_list:
            t = time.perf_counter()
            pool = render.render_pool(traffic["render"], traffic["pool"], cfg["height"],
                                      cfg["width"], float(cfg["fps"]), seed, device)
            entry = calls.make_entry(spec, cfg, traffic, pool, device)
            bases = check.sample_bases(seed, entry.bases(0), int(traffic["check"]))
            refs = {b: entry.reference(b) for b in bases}
            if kind == "program":
                answers = entry.run(0).answers
                for a in answers:
                    a.rows = calls.read_rows(a)
                answers = [a for a in answers if a.base in refs]
            else:
                answers = []
                for b in bases:
                    f, p, rows = entry.reference(b, dtype=torch.bfloat16)
                    fed = entry.reports_features
                    answers.append(calls.Answer(b, rows, f if fed else None, p if fed else None))
            nums = check.compare(answers, refs)
            rec = {"workload": workload, "kind": kind, "seed": seed, "bases": bases,
                   "nums": nums, "seconds": time.perf_counter() - t}
            out.append(rec)
            emit(json.dumps(rec))
    return out


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--control-seeds", required=True)
    ap.add_argument("--out")
    a = ap.parse_args(argv)
    ints = lambda s: [int(v) for v in s.split(",") if v]  # noqa: E731
    with open(a.out, "a") if a.out else contextlib.nullcontext() as f:
        def emit(line):
            print(line, flush=True)
            if f:
                f.write(line + "\n")
                f.flush()

        recs = readings(a.workload, ints(a.seeds), ints(a.control_seeds), emit=emit)
        for name in sorted({k for r in recs for k in r["nums"]}):
            lo = max(r["nums"][name] for r in recs if r["kind"] == "program")
            hi = min(r["nums"][name] for r in recs if r["kind"] == "control")
            emit(json.dumps({"workload": a.workload, "number": name, "lower": lo, "upper": hi}))


if __name__ == "__main__":
    main()
