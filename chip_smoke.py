"""Drive the PyTorch port's flow + PC1 main path once on one CUDA card.

    python3 chip_smoke.py        # from the repository root, one CUDA card

Phases (any failed check raises, so the exit code is non-zero):

1. device  — card name and power limit (nvidia-smi), torch / CUDA
             versions, the TF32 flags (both set False);
2. build   — nvcc builds csrc/farneback.cu for sm_90a (build/kernels/);
3. kernels — K1 poly_exp, K2 update_matrices and K3 update_flow against
             their plain PyTorch versions on bench frames at 480×640,
             B = 8, with CUDA-event medians of both;
4. slice   — the bench clip's 512 pairs as two 257-frame chunks through
             roi_body_flow_seq and then pc1_from_flow, with the launch
             counts, the kernel path against the plain path (on the card
             and on the CPU) and pairs/s beside the card's name and power;
5. profile — device time by kernel over one chunk (torch.profiler).

The second-to-last line is the kernels JSON, the last line
{"ok": true, "device": {...}}.  Imports neither JAX nor cv2.
"""

from __future__ import annotations

import json
import statistics
import subprocess
import time

import numpy as np
import torch

N_PAIRS = 512
CHUNK = 256
CHECK_PAIRS = 8
REPS = 20
SOURCE = "btcs_pnes_optical_flow_tpu_torch/csrc/farneback.cu"
PALLAS = "btcs_pnes_optical_flow_tpu/ops/farneback_pallas.py"
# (name, K, TPU kernel it replaces, tolerance against the plain version
# relative to the plain output's largest magnitude, and why).
KERNELS = (
    ("poly_exp", "K1", f"{PALLAS}:1542", 1e-5,
     "the plain fp32 tap sums in their order, without FMA contraction; "
     "room for last-bit differences of PyTorch's own kernels"),
    ("update_matrices", "K2", f"{PALLAS}:566", 1e-5,
     "the plain guard and fp32 operations in their order, without FMA contraction"),
    ("update_flow", "K3", f"{PALLAS}:1802", None,
     "flow is a quotient by a determinant that can be small; held to "
     "the path's 1e-3 px bar"),
)
FLOW_TOL_PX = 1e-3  # the JAX package's fused-vs-exact 480p bar


def _median_ms(fn, reps=REPS):
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def phase_device():
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: no CUDA device; this script measures the card only")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    print("== 1. device")
    print(smi)
    print(f"torch {torch.__version__} cuda {torch.version.cuda} "
          f"device {torch.cuda.get_device_name(0)} x{torch.cuda.device_count()}")
    print(f"allow_tf32 matmul={torch.backends.cuda.matmul.allow_tf32} "
          f"cudnn={torch.backends.cudnn.allow_tf32}")
    return smi


def phase_build():
    from btcs_pnes_optical_flow_tpu_torch.ops import _build, farneback_cuda

    print("== 2. build")
    res = _build.load("farneback.cu")
    farneback_cuda.library()
    print(f"nvcc: {' '.join(res.command) if res.command else '(cached) ' + str(res.path)}")
    for line in res.log.splitlines():
        if "registers" in line or "spill" in line or "Compiling entry" in line:
            print(f"  ptxas: {line.strip()}")
    print(f"build {res.seconds:.2f} s -> {res.path.name}")


def _rel_err(kern, plain):
    """max|kern - plain| relative to max|plain|, and the raw max."""
    d = float((kern - plain).abs().max())
    return d / max(float(plain.abs().max()), 1e-30), d


def phase_kernels(clip, params, device):
    from btcs_pnes_optical_flow_tpu_torch.ops import farneback as fb
    from btcs_pnes_optical_flow_tpu_torch.ops import farneback_cuda as fc

    print(f"== 3. kernels vs plain at 480x640, B={CHECK_PAIRS}")
    h, w = clip.shape[1:]
    frames = torch.as_tensor(clip[: CHECK_PAIRS + 1], device=device)
    lv, _, _ = fb._level_image(frames.float(), 0, params, h, w)
    lv = lv.contiguous()
    # Realistic level-0 inputs: the plain path's flow for these pairs.
    flow_plain = fb.farneback_flow_seq(frames, params, kernels=False)
    flow_cf = flow_plain.movedim(-1, 1).contiguous()
    poly = fb.poly_exp_cf_plain(lv, params.poly_n, params.poly_sigma)
    r0, r1 = poly[:-1], poly[1:]
    m = fb.update_matrices_cf_plain(r0, r1, flow_cf)
    calls = {
        "poly_exp": (lambda: fc.poly_exp_cf(lv, params.poly_n, params.poly_sigma),
                     lambda: fb.poly_exp_cf_plain(lv, params.poly_n, params.poly_sigma)),
        "update_matrices": (lambda: fc.update_matrices_cf(r0, r1, flow_cf),
                            lambda: fb.update_matrices_cf_plain(r0, r1, flow_cf)),
        "update_flow": (lambda: fc.update_flow_cf(m, params.winsize, params.gaussian_win),
                        lambda: fb.update_flow_cf_plain(m, params.winsize, params.gaussian_win)),
    }
    rows = {}
    for name, kid, replaces, rtol, why in KERNELS:
        kern_fn, plain_fn = calls[name]
        kern = kern_fn()
        plain = plain_fn()
        torch.cuda.synchronize()
        rel, abs_err = _rel_err(kern, plain)
        if not torch.isfinite(kern).all():
            raise AssertionError(f"{name}: non-finite kernel output")
        ok = abs_err <= FLOW_TOL_PX if rtol is None else rel <= rtol
        bar = f"{FLOW_TOL_PX} px abs" if rtol is None else f"{rtol} x max|plain|"
        for _ in range(3):
            kern_fn(), plain_fn()
        ms_k, ms_p = [], []
        for _ in range(2):  # plain, kernel, kernel, plain
            ms_p.append(_median_ms(plain_fn))
            ms_k.append(_median_ms(kern_fn))
            ms_k.append(_median_ms(kern_fn))
            ms_p.append(_median_ms(plain_fn))
        rows[name] = dict(name=name, route="cuda", source=SOURCE, replaces=replaces,
                          launches=0, max_abs_err=abs_err,
                          ms=statistics.median(ms_k), plain_ms=statistics.median(ms_p))
        print(f"{kid} {name}: max_abs_err {abs_err:.3e} rel {rel:.3e} (tol {bar}: {why}) "
              f"{'ok' if ok else 'FAIL'}; kernel {rows[name]['ms']:.4f} ms "
              f"plain {rows[name]['plain_ms']:.4f} ms (median of {REPS}, 4 rounds)")
        if not ok:
            raise AssertionError(f"{name} disagrees with its plain version")
    return rows, flow_plain


def phase_slice(clip, params, device, smi, rows, flow_plain):
    from bench import H, W
    from btcs_pnes_optical_flow_tpu_torch.config import PCAParams
    from btcs_pnes_optical_flow_tpu_torch.models.flow import roi_body_flow_seq, to_device
    from btcs_pnes_optical_flow_tpu_torch.models.pc1 import pc1_from_flow
    from btcs_pnes_optical_flow_tpu_torch.ops import farneback as fb
    from btcs_pnes_optical_flow_tpu_torch.ops import farneback_cuda as fc
    from btcs_pnes_optical_flow_tpu_torch.ops.cvx import fill_poly_mask

    print(f"== 4. slice: {N_PAIRS} pairs of {H}x{W}, chunks of {CHUNK}, then PC1")
    # The kernel path against the plain path on the card (first 8 pairs).
    head = torch.as_tensor(clip[: CHECK_PAIRS + 1], device=device)
    flow_kern = fb.farneback_flow_seq(head, params)
    d = float((flow_kern - flow_plain).abs().max())
    print(f"kernel vs plain path on the card, {CHECK_PAIRS} pairs: max |dflow| {d:.3e} px "
          f"(bar {FLOW_TOL_PX})")
    if not d <= FLOW_TOL_PX:
        raise AssertionError("kernel path disagrees with the plain path")
    # ... and against the plain path on the CPU at a small size.
    small = np.ascontiguousarray(clip[:3, ::5, ::5])
    f_cpu = fb.farneback_flow_seq(torch.as_tensor(small), params)
    f_gpu = fb.farneback_flow_seq(torch.as_tensor(small, device=device), params).cpu()
    d_small = float((f_cpu - f_gpu).abs().max())
    print(f"kernel path on the card vs plain path on the CPU, 2 pairs {small.shape[1:]}: "
          f"max |dflow| {d_small:.3e} px (bar {FLOW_TOL_PX})")
    if not d_small <= FLOW_TOL_PX:
        raise AssertionError("card disagrees with the CPU")

    roi = np.array([[140.0, 90.0], [520.0, 110.0], [500.0, 400.0], [120.0, 380.0]])
    theta = 0.3
    ex = np.tile(np.array([np.cos(theta), -np.sin(theta)], np.float32), (CHUNK, 1))
    ey = np.tile(np.array([np.sin(theta), np.cos(theta)], np.float32), (CHUNK, 1))
    mask = fill_poly_mask(H, W, roi)[None]
    frames, exd, eyd, masks = to_device(clip, ex, ey, mask, device)
    chunks = [frames[s : s + CHUNK + 1] for s in range(0, N_PAIRS, CHUNK)]
    roi_body_flow_seq(chunks[0][: CHECK_PAIRS + 1], exd[:CHECK_PAIRS], eyd[:CHECK_PAIRS],
                      masks, params)  # warm-up (allocator, einsum)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()

    fc.reset_launch_counts()
    t0 = time.perf_counter()
    outs = [roi_body_flow_seq(c, exd, eyd, masks, params) for c in chunks]
    vx_h = torch.cat([f.vx[:, 0] for f, _ in outs]).cpu()
    vy_h = torch.cat([f.vy[:, 0] for f, _ in outs]).cpu()
    mg_h = torch.cat([f.mag[:, 0] for f, _ in outs]).cpu()
    clips = torch.cat([c for _, c in outs]).cpu()
    flow_time = time.perf_counter() - t0
    launches = dict(fc.LAUNCHES)

    n_chunks = len(chunks)
    n_lev = params.num_levels(H, W) + 1
    n_it = sum(params.iters_at(k) for k in range(n_lev))
    want = {"poly_exp": n_lev * n_chunks, "update_matrices": n_it * n_chunks,
            "update_flow": n_it * n_chunks}
    print(f"launches over {n_chunks} chunks: {launches} (expected {want}: "
          f"{n_lev}/{n_it}/{n_it} per chunk)")
    if launches != want:
        raise AssertionError("launch counts differ from the main path's schedule")
    for name in rows:
        rows[name]["launches"] = launches[name]
    if vx_h.shape != (N_PAIRS,) or clips.shape != (N_PAIRS,):
        raise AssertionError(f"feature shapes {tuple(vx_h.shape)}, clips {tuple(clips.shape)}")
    if int(clips.abs().sum()) != 0:
        raise AssertionError("non-zero clip counts")
    for nm, v in (("vx", vx_h), ("vy", vy_h), ("mag", mg_h)):
        if not torch.isfinite(v).all():
            raise AssertionError(f"non-finite {nm} features")
    print(f"features finite; |vx| max {float(vx_h.abs().max()):.4f} "
          f"|vy| max {float(vy_h.abs().max()):.4f} px/frame; clips all zero")

    pca = PCAParams()
    nan = torch.tensor([float("nan")])
    vx = torch.cat([nan, vx_h]).to(device)
    vy = torch.cat([nan, vy_h]).to(device)
    pc1_from_flow(vx, vy, pca)  # warm-up
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    pc1 = pc1_from_flow(vx, vy, pca).cpu()
    pca_time = time.perf_counter() - t0
    expect_nan = torch.zeros(N_PAIRS + 1, dtype=torch.bool)
    expect_nan[0] = True
    if not torch.equal(torch.isnan(pc1), expect_nan):
        raise AssertionError("PC1 is NaN outside index 0, or finite at index 0")
    pc1_cpu = pc1_from_flow(vx.cpu(), vy.cpu(), pca)
    corr = float(np.corrcoef(pc1[1:].numpy(), pc1_cpu[1:].numpy())[0, 1])
    dmax = float((pc1[1:] - pc1_cpu[1:]).abs().max())
    print(f"PC1 {tuple(pc1.shape)} finite past index 0; card vs CPU corr {corr:.9f} max |d| {dmax:.3e}")
    if not corr >= 0.9999:
        raise AssertionError("PC1 on the card disagrees with the CPU")

    peak = torch.cuda.max_memory_allocated() / 2**30
    print(f"flow {flow_time:.4f} s ({N_PAIRS / flow_time:.2f} pairs/s), "
          f"PC1 {pca_time:.4f} s, flow+PCA {N_PAIRS / (flow_time + pca_time):.2f} ROI-frames/s, "
          f"peak {peak:.2f} GiB on [{smi}]")
    return chunks[0], exd, eyd, masks


def phase_profile(chunk, exd, eyd, masks, params):
    from torch.profiler import ProfilerActivity, profile

    from btcs_pnes_optical_flow_tpu_torch.models.flow import roi_body_flow_seq

    print("== 5. device time by kernel, one chunk")
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        roi_body_flow_seq(chunk, exd, eyd, masks, params)
        torch.cuda.synchronize()

    def dev_us(e):  # named self_cuda_time_total before torch 2.4
        return getattr(e, "self_device_time_total", None) or getattr(e, "self_cuda_time_total", 0)

    cuda = torch.autograd.DeviceType.CUDA
    events = [e for e in prof.key_averages() if getattr(e, "device_type", None) == cuda]
    total = sum(dev_us(e) for e in events)
    if not total:
        print("profiler recorded no device time")
        return
    for e in sorted(events, key=lambda e: -dev_us(e))[:12]:
        print(f"  {dev_us(e) / 1e3:9.3f} ms {100 * dev_us(e) / total:5.1f}% "
              f"x{e.count:<5d} {e.key[:90]}")
    print(f"  total device time {total / 1e3:.3f} ms over {len(events)} kernel names")


def main():
    smi = phase_device()
    from bench import render_clip
    from btcs_pnes_optical_flow_tpu_torch.config import FarnebackParams, check_supported

    device = torch.device("cuda", 0)
    params = check_supported(FarnebackParams())
    phase_build()
    t0 = time.perf_counter()
    clip = render_clip(N_PAIRS + 1)
    print(f"bench clip {clip.shape} rendered in {time.perf_counter() - t0:.1f} s")
    rows, flow_plain = phase_kernels(clip, params, device)
    chunk, exd, eyd, masks = phase_slice(clip, params, device, smi, rows, flow_plain)
    phase_profile(chunk, exd, eyd, masks, params)
    print(json.dumps({"kernels": [rows[name] for name, *_ in KERNELS]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
