"""K3, the window average and 2x2 solve of one Farnebäck iteration (the
program's ``update_flow_kernel``, whole level or box).

Per pixel: M's 5 float32 planes in and the flow's 2 out; per plane two
passes of winsize taps and one final scale of the box window, then the
regularised solve (12 operations).
"""

PATTERN = r"update_flow_kernel"


def per_pixel(work):
    return 4 * (5 + 2), 5 * (2 * (work.winsize - 1) + 1) + 12
