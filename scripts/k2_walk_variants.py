"""Time alternative forms of K2's walk against the shipped kernel on one card.

    python3 scripts/k2_walk_variants.py      # from the repository root, one CUDA card

Builds scripts/k2_walk_variants.cu (the shipped csrc/farneback.cu plus the
alternatives) with the port's nvcc flags into build/kernels/, then at the
main path's K2 shapes (the 1080p bench config's level-0 box, level 0
whole, level 2's box and level 3 at 64 pairs in bf16; 480p whole and its
ROI box at 256 pairs in fp32) holds every form to the plain version
(torch.equal) and times them in turns on the same tensors (CUDA-event
medians of 10 launches, each form twice in forward and twice in reverse
order).  The forms: the shipped kernel with the wrapper's run length
(WALK_WAVES) and with the run lengths of 8 and 32 waves and one run;
shared-memory staging of r0 and flow with 16-byte cp.async and a barrier
per pair; the next pair's r0 held in registers as well as its flow; tiles
of 4 rows; the shipped code without its minimum of 5 blocks per SM (ptxas
then picks its own register count); and the earlier designs (the pre-walk K2 on a whole level, K4
over the box's tile list on a box).  Inputs: shifted crops of one smoothed
random image (torch.Generator seeded), its expansion by K1, and a flow of
(1.3, -0.7) px plus N(0, 0.4²) noise.
"""

from __future__ import annotations

import ctypes
import pathlib
import statistics
import subprocess
import sys
import time

import torch

ROOT = pathlib.Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

from btcs_pnes_optical_flow_tpu_torch.ops import _build  # noqa: E402
from btcs_pnes_optical_flow_tpu_torch.ops import farneback as fb  # noqa: E402
from btcs_pnes_optical_flow_tpu_torch.ops import farneback_cuda as fc  # noqa: E402

HBM_BYTES_PER_S = 3.35e12
REPS = 10
# (label, pairs, h, w, box, precision)
CASES = [
    ("1080p level-0 box", 64, 1080, 1920, (232, 936, 320, 1600), "bf16"),
    ("1080p level 0 whole", 64, 1080, 1920, (0, 1080, 0, 1920), "bf16"),
    ("1080p level-2 box", 64, 270, 480, (16, 270, 32, 448), "bf16"),
    ("1080p level 3 whole", 64, 135, 240, (0, 135, 0, 240), "bf16"),
    ("480p whole", 256, 480, 640, (0, 480, 0, 640), "fp32"),
    ("480p ROI box", 256, 480, 640, (56, 432, 64, 576), "fp32"),
]
VARIANTS = {1: "shared-memory staging", 2: "r0 prefetch too", 3: "4-row tiles",
            4: "no minimum of blocks per SM"}


def build():
    src = ROOT / "scripts" / "k2_walk_variants.cu"
    out = _build.BUILD_DIR / "libk2_walk_variants.so"
    _build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    t0 = time.perf_counter()
    proc = subprocess.run([_build.find_nvcc(), *_build.NVCC_FLAGS, "-o", str(out), str(src)],
                          capture_output=True, text=True)
    if proc.returncode:
        raise RuntimeError(f"nvcc failed:\n{proc.stdout}{proc.stderr}")
    print(f"built {out.name} in {time.perf_counter() - t0:.1f} s")
    lines = (proc.stdout + proc.stderr).splitlines()
    for i, line in enumerate(lines):
        if "Compiling entry" in line and ("walk" in line or "staged" in line or "unbounded" in line
                                          or "update_matrices_kernel" in line):
            regs = [x.split(":", 1)[-1].strip() for x in lines[i + 1:i + 4]
                    if "registers" in x or "spill" in x]
            print(f"  {line.split(chr(39))[1]}: {'; '.join(regs)}")
    lib = ctypes.CDLL(str(out))
    p, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    lib.k2v_launch.argtypes = [i, p, p, p, p, p, ll, i, i, i, i, i, i, i, i, p]
    lib.k2v_resident.argtypes = [i, i, ctypes.POINTER(i)]
    lib.k2v_rows.argtypes = [i]
    return lib


def median_ms(fn):
    times = []
    for _ in range(REPS):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def inputs(b, h, w, device):
    g = torch.Generator(device=device).manual_seed(1)
    base = torch.rand((h + 16, w + 16), generator=g, device=device) * 255
    base = torch.nn.functional.avg_pool2d(base[None, None], 5, 1, 2)[0, 0]
    frames = torch.stack([base[i % 7:i % 7 + h, (2 * i) % 9:(2 * i) % 9 + w]
                          for i in range(b + 1)]).contiguous()
    poly = fc.poly_exp_cf(frames, 5, 1.2)
    flow = torch.randn((b, 2, h, w), generator=g, device=device) * 0.4
    flow[:, 0] += 1.3
    flow[:, 1] -= 0.7
    return poly, flow.contiguous()


def run_case(lib, device, label, b, h, w, box, precision):
    poly, flow = inputs(b, h, w, device)
    r0, r1 = poly[:-1], poly[1:]
    bf16 = int(precision == "bf16")
    rim = fc._rim_rows(h, w, 0, h, device)
    y0, y1, x0, x1 = box
    px = b * (y1 - y0) * (x1 - x0)
    bound = px * 4 * (5 * (b + 1) / b + 7) / HBM_BYTES_PER_S * 1e3
    plain = fb.update_matrices_cf_plain(r0, r1, flow, precision)
    out = torch.zeros_like(r0)
    stream = torch.cuda.current_stream(device).cuda_stream
    forms = {}

    def resident(variant):
        n = ctypes.c_int(0)
        err = lib.k2v_resident(variant, bf16, ctypes.byref(n))
        if err:
            raise RuntimeError(f"k2v_resident: CUDA error {err}")
        return n.value

    def add(name, variant, ppr):
        def fn():
            err = lib.k2v_launch(variant, r0.data_ptr(), r1.data_ptr(), flow.data_ptr(),
                                 rim.data_ptr(), out.data_ptr(), b, h, w, y0, y1, x0, x1, ppr,
                                 bf16, stream)
            if err:
                raise RuntimeError(f"{name}: CUDA error {err}")
        out.zero_()
        fn()
        torch.cuda.synchronize()
        if not torch.equal(out[:, :, y0:y1, x0:x1], plain[:, :, y0:y1, x0:x1]):
            raise AssertionError(f"{label}: {name} differs from the plain version")
        forms[name] = fn

    res = resident(0)
    n_tiles = -(-(y1 - y0) // 8) * -(-(x1 - x0) // 32)
    ppr = fc.pairs_per_run(n_tiles, b, res)
    add(f"K2, {fc.WALK_WAVES} waves (P={ppr})", 0, ppr)
    for waves in (8, 32):
        p = fc.pairs_per_run(n_tiles, b, res * waves // fc.WALK_WAVES)
        add(f"K2, {waves} waves (P={p})", 0, p)
    add(f"K2, one run (P={b})", 0, b)
    for variant, name in VARIANTS.items():
        tiles = -(-(y1 - y0) // lib.k2v_rows(variant)) * -(-(x1 - x0) // 32)
        p = fc.pairs_per_run(tiles, b, resident(variant))
        add(f"{name} (P={p})", variant, p)
    if box == (0, h, 0, w):
        forms["pre-walk K2"] = lambda: fc.update_matrices_rows_cf(r0, r1, flow, 0, h, precision)
    else:
        tiles = (y0 // 8, -(-y1 // 8), x0 // 32, -(-x1 // 32))
        sel = fb.tile_list(b, tiles, h, w, device)
        forms["K4 over the box's tiles"] = lambda: fc.update_matrices_tiles_cf(
            r0, r1, flow, sel, out, fb.TILE, precision)
    times = {name: [] for name in forms}
    for fn in forms.values():
        fn()
    names = list(forms)
    for order in (names, names[::-1]):
        for name in order:
            times[name] += [median_ms(forms[name]), median_ms(forms[name])]
    print(f"== {label}: {b} pairs of {h}x{w}, box {box}, {precision}, bound {bound:.4f} ms "
          f"({px} px)")
    for name in names:
        t = statistics.median(times[name])
        print(f"  {name:36s} {t:8.4f} ms  {100 * bound / t:5.1f}% of the bound")


def main():
    if not torch.cuda.is_available():
        raise SystemExit("k2_walk_variants: no CUDA device")
    device = torch.device("cuda", 0)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip()
    print(smi)
    lib = build()
    for case in CASES:
        run_case(lib, device, *case)
        torch.cuda.empty_cache()


if __name__ == "__main__":
    main()
