"""Reference-script compatibility layer.

The reference's public API is its three entry-point scripts
(optical_flow.py / optical_PCA.py / optical_PC1.py) and their file
contracts.  These modules expose the same call signatures and artifacts as
the JAX package's ``compat`` modules, backed by the port: the flow runs on
the card's kernels, and every helper and ``main`` takes the ``device`` it
runs on (the card unless the caller passes ``"cpu"``).  They include
working versions of the three functions the reference calls but never
defines (estimate_fs_from_time, safe_auc, exp_decay_regression), so the
metrics entry point runs.
"""
