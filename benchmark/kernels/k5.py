"""K5, TV-L1's warp sampler (the program's ``warp_sample_kernel``): the
bilinear sample of C float32 planes at (x + u, y + v), clamped to the
frame, once a warp.

Per pixel: the flow's 2 planes and the C source planes read once, the C
samples written, float32; the two coordinates' add and clamp, the floors
and fractions (10 operations) and per channel the bilinear blend (6).
TV-L1 samples (I1, I1x, I1y): C = 3, 32 bytes and 28 operations a pixel.
"""

PATTERN = r"warp_sample_kernel"
CHANNELS = 3


def launch(pixels: int, channels: int = CHANNELS):
    """(bytes, float32 operations) of one launch over ``pixels`` pixels
    (pairs times the level's pixels)."""
    return pixels * 4 * (2 * channels + 2), pixels * (10 + 6 * channels)
