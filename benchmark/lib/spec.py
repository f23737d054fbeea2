"""Everything a run finds by name: the cell in ``BENCHMARK.json``, its
configuration file, its traffic mix (``traffic/<mix>.json``), the entry
module the mix names (``entries/<entry>.py``), its limits
(``limits/<cell>.json``), the per-layer metric readers
(``metrics/<metric>.py``) and the kernels' work counts
(``kernels/<kernel>.py``).  A new cell adds files and entries; no file
here names one."""

from __future__ import annotations

import importlib.util
import json
import pathlib

BENCH_DIR = pathlib.Path(__file__).resolve().parents[1]
ROOT = BENCH_DIR.parent


class Spec:
    """``BENCHMARK.json`` of the checkout at ``root``, with lookups by name."""

    def __init__(self, root=ROOT):
        self.root = pathlib.Path(root)
        self.bench_dir = self.root / "benchmark"
        self.data = _json(self.root / "BENCHMARK.json")

    def workload(self, name: str) -> dict:
        for w in self.data["workloads"]:
            if w["name"] == name:
                return w
        raise KeyError(f"no workload {name!r} in BENCHMARK.json")

    def config(self, name: str) -> dict:
        for c in self.data["configs"]:
            if c["name"] == name:
                return _json(self.root / c["file"])
        raise KeyError(f"no config {name!r} in BENCHMARK.json")

    def traffic(self, name: str) -> dict:
        return _json(self.bench_dir / "traffic" / f"{name}.json")

    def limits(self, workload: str) -> dict:
        return _json(self.bench_dir / "limits" / f"{workload}.json")

    def metrics_of(self, workload: str, kind: str) -> list:
        """The ``end_to_end`` or ``per_layer`` entries that this cell reports."""
        return [m for m in self.data[kind] if workload in m.get("workloads", [workload])]

    def entry(self, name: str):
        """The module ``entries/<name>.py``: the loop, warm-up and
        reference answer of one of the program's entry points."""
        return load_module(self.bench_dir / "entries" / f"{name}.py")

    def metric_reader(self, name: str):
        """The reader of a per-layer metric: ``metrics/<name>.py``; else
        ``metrics/<base>.py``, where ``<base>`` is the name before its cell
        suffix (``.recording``, ``.cohort``); else, for a base
        ``<kernel>_<rest>`` whose kernel has a file under ``kernels/``,
        ``metrics/<rest>.py`` (``k2_roofline`` is read by ``roofline.py``)."""
        base = name.split(".")[0]
        names = [name, base]
        for i, c in enumerate(base):
            if c == "_" and (self.bench_dir / "kernels" / f"{base[:i]}.py").exists():
                names.append(base[i + 1:])
        for n in names:
            path = self.bench_dir / "metrics" / f"{n}.py"
            if path.exists():
                return load_module(path)
        raise FileNotFoundError(f"no reader of metric {name!r}: tried {names} under metrics/")

    def kernel(self, name: str):
        return load_module(self.bench_dir / "kernels" / f"{name}.py")


def _json(path):
    with open(path) as f:
        return json.load(f)


_MODULES: dict = {}


def load_module(path):
    """The module in the file ``path`` (its name may hold dots), loaded once."""
    path = pathlib.Path(path)
    key = str(path.resolve())
    if key not in _MODULES:
        spec = importlib.util.spec_from_file_location(
            f"benchmark_{path.parent.name}_" + path.stem.replace(".", "_"), path)
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
        _MODULES[key] = mod
    return _MODULES[key]
