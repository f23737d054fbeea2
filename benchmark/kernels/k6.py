"""K6, TV-L1's fixed-length primal-dual chain (the program's
``pd_block_kernel<D>``; a chain of n iterations is ceil(n / 8) launches).

Per pixel and chain: the six planes (u, v, rho_c, I1wx, I1wy, |grad I|^2)
read once and u, v written once, float32, whatever the launches keep
between them; 7 operations per chain for the hoisted invariants and 50 an
iteration (counted from ``pd_chain_plain``: rho, the thresholds and the
data step, two divergences, the u and v updates, four differences, two
gradient norms with their square roots, two reciprocal factors and four
dual updates; a square root or a division counts as one).
"""

PATTERN = r"pd_block_kernel"
OPS_PER_CHAIN = 7
OPS_PER_ITERATION = 4 + 2 + 2 + 6 + 6 + 4 + 8 + 6 + 12


def chain(pixels: int, n_iterations: int):
    """(bytes, float32 operations) of one chain over ``pixels`` pixels
    (pairs times the level's pixels)."""
    return pixels * 4 * (6 + 2), pixels * (OPS_PER_CHAIN + OPS_PER_ITERATION * n_iterations)
