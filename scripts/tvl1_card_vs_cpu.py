"""What moves the port's TV-L1 flow between an NVIDIA card and the CPU, shown
on the CPU alone: chip_smoke.py phase 17's input (render_clip(3, 112, 896,
seed=2), pd_engine "resident"), run once as the CPU runs it and once with
one of the card's float32 roundings in its place:

- frames / 255 as the card computed it before ``ops/tvl1.py _unit``: a CUDA
  tensor divided by a Python scalar is multiplied by the scalar's float32
  reciprocal;
- a correctly rounded square root, as the card's: the CPU's torch.sqrt
  (vectorised, AVX-512) is not correctly rounded for every input.

    python3 scripts/tvl1_card_vs_cpu.py     # from the repository root, CPU only

Prints, for each, the pixel values or inputs it rounds apart and the max and
mean |dflow| in px it makes.
"""

import dataclasses
import pathlib
import sys

import numpy as np
import torch

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parent.parent))

from bench import render_clip  # noqa: E402
from btcs_pnes_optical_flow_tpu_torch.ops import tvl1 as tv  # noqa: E402


def flow(clip, p):
    return tv.tvl1_flow(torch.as_tensor(clip[:-1]), torch.as_tensor(clip[1:]), p)


def report(what, base, other):
    d = (base - other).abs()
    print(f"{what}: max |dflow| {float(d.max()):.4e} px, mean {float(d.mean()):.4e} px, "
          f"{int((d > 1e-4).sum())} of {d.numel()} components past 1e-4 px")


def main():
    clip = render_clip(3, 112, 896, seed=2)
    p = dataclasses.replace(tv.TVL1Params(), pd_engine="resident")
    base = flow(clip, p)

    values = torch.arange(256, dtype=torch.float32)
    recip = torch.tensor(1.0 / 255.0, dtype=torch.float32)
    print(f"x / 255 vs x * float32(1/255): {int((values / 255.0 != values * recip).sum())} of "
          "256 pixel values differ")
    unit = tv._unit
    tv._unit = lambda frames: frames.float() * recip
    try:
        report("frames scaled by the reciprocal (the card before _unit)", base, flow(clip, p))
    finally:
        tv._unit = unit

    x = torch.as_tensor(np.random.default_rng(0).random(10**6, dtype=np.float32) * 10)
    exact = torch.sqrt(x.double()).float()
    print(f"torch.sqrt vs a correctly rounded sqrt: {int((torch.sqrt(x) != exact).sum())} of "
          f"{x.numel()} float32 inputs differ on this CPU")
    sqrt = torch.sqrt
    tv.torch.sqrt = lambda t: sqrt(t.double()).float()
    try:
        report("a correctly rounded sqrt (the card's)", base, flow(clip, p))
    finally:
        tv.torch.sqrt = sqrt


if __name__ == "__main__":
    main()
