"""Nothing the benchmark runs imports JAX, the JAX package, the JAX bench
or the chip smoke script, and the reference imports nothing of the port.
Top-level names are compared whole: the port's name begins with the JAX
package's."""

import ast
import pathlib

BENCH = pathlib.Path(__file__).resolve().parents[1]
FORBIDDEN = {"jax", "jaxlib", "flax", "btcs_pnes_optical_flow_tpu", "bench", "chip_smoke"}
PORT = "btcs_pnes_optical_flow_tpu_torch"


def _top_names(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    names = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names.update(a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names.add(node.module)
    return names


def _modules(sub=""):
    return sorted(p for p in (BENCH / sub).rglob("*.py") if "__pycache__" not in p.parts)


def test_no_benchmark_module_imports_jax_or_the_jax_package():
    seen = 0
    for path in _modules():
        tops = {n.split(".")[0] for n in _top_names(path)}
        assert not tops & FORBIDDEN, f"{path} imports {sorted(tops & FORBIDDEN)}"
        seen += 1
    assert seen >= 20


def test_the_reference_imports_nothing_of_the_port():
    for path in _modules("reference"):
        for name in _top_names(path):
            top = name.split(".")[0]
            assert top != PORT, f"{path} imports {name}"
            assert top != "benchmark" or name.startswith("benchmark.reference"), (path, name)


def test_the_run_time_guard_compares_whole_top_level_names(monkeypatch):
    import sys
    import types

    from benchmark.lib import harness

    monkeypatch.setitem(sys.modules, PORT + ".fake", types.ModuleType(PORT + ".fake"))
    assert not [m for m in harness._forbidden_modules() if m.startswith(PORT)]
    monkeypatch.setitem(sys.modules, "jax.fake", types.ModuleType("jax.fake"))
    assert "jax.fake" in harness._forbidden_modules()
