"""K2, the warp and normal-equation assembly of one Farnebäck iteration
(the program's ``update_matrices_kernel``, whole level or box).

Per pixel of a chunk of b pairs whose two expansions are consecutive
frames of one (b+1)-frame expansion: the 5 expansion planes of b+1 frames
read once, the flow's 2 planes in, M's 5 planes out, float32; the bilinear
warp, the averages, the rim damping and the assembly take 70 float32
operations; the bfloat16 lerp adds 2 weight roundings and, per channel and
row, 2 tap, 2 product and 1 sum rounding (52).
"""

PATTERN = r"update_matrices_kernel"
BF16_EXTRA_OPS = 52


def per_pixel(work):
    b = work.pairs
    ops = 70 + (BF16_EXTRA_OPS if work.precision == "bf16" else 0)
    return 4 * (5 * (b + 1) / b + 2 + 5), ops
