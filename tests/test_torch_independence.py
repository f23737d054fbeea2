"""The port stands alone: no module of it imports the JAX package, and its
own copies of the JAX package's jax-free modules (config, filter design,
CSV contracts) agree with the originals."""

import ast
import dataclasses
import os
import pathlib
from collections import namedtuple

import numpy as np
import pytest
import scipy.signal

from btcs_pnes_optical_flow_tpu import config as jconfig
from btcs_pnes_optical_flow_tpu.dataio import contracts as jcontracts
from btcs_pnes_optical_flow_tpu.ops import design as jdesign
from btcs_pnes_optical_flow_tpu_torch import config as tconfig
from btcs_pnes_optical_flow_tpu_torch.dataio import contracts as tcontracts
from btcs_pnes_optical_flow_tpu_torch.ops import design as tdesign

REPO = pathlib.Path(__file__).resolve().parent.parent
JAX_PACKAGE = "btcs_pnes_optical_flow_tpu"


def _imported_top_names(path: pathlib.Path):
    names = set()
    for node in ast.walk(ast.parse(path.read_text(), str(path))):
        if isinstance(node, ast.Import):
            names.update(a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            names.add(node.module.split(".")[0])
    return names


def test_no_module_of_the_port_imports_the_jax_package():
    files = sorted((REPO / "btcs_pnes_optical_flow_tpu_torch").rglob("*.py"))
    files.append(REPO / "chip_smoke.py")
    assert len(files) > 20
    scanned = {f.relative_to(REPO / "btcs_pnes_optical_flow_tpu_torch").parts[0] for f in files[:-1]}
    assert {"compat", "parallel", "dataio", "models", "ops"} <= scanned
    rel = {f.relative_to(REPO).as_posix() for f in files}
    assert {f"btcs_pnes_optical_flow_tpu_torch/parallel/{m}.py"
            for m in ("mesh", "cohort", "runner", "halo", "spatial")} <= rel
    assert "btcs_pnes_optical_flow_tpu_torch/ops/farneback_fused.py" in rel
    offenders = {str(f.relative_to(REPO)): sorted(n & {JAX_PACKAGE, "jax", "jaxlib"})
                 for f in files for n in [_imported_top_names(f)]
                 if n & {JAX_PACKAGE, "jax", "jaxlib"}}
    assert not offenders, offenders


@pytest.mark.parametrize("name", ["FarnebackParams", "PCAParams", "MetricParams",
                                  "PipelineConfig"])
def test_dataclasses_have_the_jax_fields_and_defaults(name):
    j, t = getattr(jconfig, name), getattr(tconfig, name)
    assert dataclasses.is_dataclass(t) and t.__dataclass_params__.frozen
    jf = [(f.name, f.default) for f in dataclasses.fields(j)]
    tf = [(f.name, f.default) for f in dataclasses.fields(t)]
    assert [n for n, _ in tf] == [n for n, _ in jf]
    for (n, dj), (_, dt) in zip(jf, tf):
        if dataclasses.is_dataclass(dj):
            assert dataclasses.asdict(dt) == dataclasses.asdict(dj), n
        else:
            assert dt == dj, n
    assert dataclasses.asdict(t()) == dataclasses.asdict(j())


def test_from_fields_carries_a_jax_config_across():
    jcfg = jconfig.PipelineConfig(
        flow=jconfig.FarnebackParams(winsize=7, iter_schedule=(3, 2), roi_active_px=((0, 8, 0, 8),)),
        pca=jconfig.PCAParams(win_sec=1.5), metrics=jconfig.MetricParams(window_sec=3.0))
    cfg = tconfig.from_fields(jcfg)
    assert type(cfg) is tconfig.PipelineConfig and type(cfg.flow) is tconfig.FarnebackParams
    assert dataclasses.asdict(cfg) == dataclasses.asdict(jcfg)
    assert cfg.pca.win_n == jcfg.pca.win_n and cfg.flow.iters_at(5) == 2
    assert cfg.flow.level_size(481, 639, 2) == jcfg.flow.level_size(481, 639, 2)
    with pytest.raises(TypeError):
        tconfig.from_fields(object())
    for x in (0.5, 1.5, 2.5, -0.5, 3.49, 7.5000001):
        assert tconfig._round_half_even(x) == jconfig._round_half_even(x) == round(x)


@pytest.mark.parametrize("low,high,fs,order", [(0.5, 5.0, 30.0, 4), (0.3, 8.0, 25.0, 2),
                                               (1.0, 12.0, 60.0, 3)])
def test_design_equals_jax_and_scipy(low, high, fs, order):
    sos = tdesign.butter_bandpass_sos(low, high, fs, order)
    assert np.array_equal(sos, jdesign.butter_bandpass_sos(low, high, fs, order))
    zi = tdesign.sosfilt_zi(sos)
    assert np.array_equal(zi, jdesign.sosfilt_zi(sos))
    assert tdesign.sos_required_padlen(sos) == jdesign.sos_required_padlen(sos)
    ref = scipy.signal.butter(order, [low / (fs / 2), high / (fs / 2)], btype="band",
                              output="sos")
    np.testing.assert_allclose(sos, ref, rtol=0, atol=1e-12)
    np.testing.assert_allclose(zi, scipy.signal.sosfilt_zi(ref), rtol=0, atol=1e-12)
    with pytest.raises(ValueError):
        tdesign.butter_bandpass_sos(high, low, fs, order)


# Values whose text form differs between naive formatters: NaN (empty),
# -0.0, an integral float, tiny and huge magnitudes, float32 widened.
EDGE = np.array([np.nan, -0.0, 1.0, 1e-300, 1e16, 0.1, 1 / 3, float(np.float32(0.3)),
                 123456789.125, -2.5e-07, 5e-324, 1.7976931348623157e308, 1e22, 0.0])
with np.errstate(over="ignore"):
    EDGE_F32 = EDGE.astype(np.float32)  # PC1 is float32: the largest values become inf


def _bytes(path):
    return pathlib.Path(path).read_bytes()


def test_csv_writers_give_the_jax_bytes(tmp_path):
    n = len(EDGE)
    args = (np.arange(n), EDGE, np.arange(n) * 3, np.arange(n) % 2, EDGE, EDGE[::-1],
            np.abs(EDGE))
    jcontracts.flow_frame(*args).to_csv(tmp_path / "j_flow.csv", index=False)
    tcontracts.write_flow_csv(str(tmp_path / "flow.csv"), *args)
    jcontracts.pc1_frame(EDGE, EDGE_F32).to_csv(tmp_path / "j_pc1.csv", index=False)
    tcontracts.write_pc1_csv(str(tmp_path / "pc1.csv"), EDGE, EDGE_F32)
    m = namedtuple("M", "pc1_area ads_slope ads_r2 kendall_tau kendall_p peak_n")
    for i, row in enumerate([m(np.float32(1.5), np.nan, -0.0, 1e16, 1e-300, np.int32(7)),
                             m(1.0, 0.1, 1 / 3, -2.5e-07, 0.0, 0)]):
        jcontracts.summary_frame(row, 3.0).to_csv(tmp_path / f"j_summary{i}.csv", index=False)
        tcontracts.write_summary_csv(str(tmp_path / f"summary{i}.csv"), row, 3.0)
    names = ["flow", "pc1", "summary0", "summary1"]
    for k in names:
        assert _bytes(tmp_path / f"{k}.csv") == _bytes(tmp_path / f"j_{k}.csv"), k
    assert b"\r" not in _bytes(tmp_path / "flow.csv")
    assert tcontracts.FLOW_COLUMNS == jcontracts.FLOW_COLUMNS
    assert tcontracts.PC1_COLUMNS == jcontracts.PC1_COLUMNS
    assert tcontracts.SUMMARY_COLUMNS == jcontracts.SUMMARY_COLUMNS


def test_skeleton_npz_round_trip(tmp_path):
    rng = np.random.default_rng(0)
    skel = tcontracts.Skeleton(np.arange(5) / 30.0, 30.0, rng.normal(size=(5, 2)),
                               rng.normal(size=(5, 2)))
    skel.ex[2] = np.nan
    path = os.path.join(tmp_path, "skeleton_pc1.npz")
    tcontracts.save_skeleton_npz(path, skel)
    mine, theirs = tcontracts.load_skeleton_npz(path), jcontracts.load_skeleton_npz(path)
    for a, b, c in zip(mine, theirs, skel):
        assert np.array_equal(a, b, equal_nan=True) and np.array_equal(a, c, equal_nan=True)
