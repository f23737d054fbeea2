"""Cohort execution on the card.

Port of ``btcs_pnes_optical_flow_tpu/parallel``'s cohort path:

- ``mesh``   — the devices a cohort runs on (one CUDA card);
- ``cohort`` — a cohort's flow stage batched on the card, videos staged
  once and sliced there (the JAX package shards it over a mesh);
- ``runner`` — ``run_cohort``: many recordings → one metric row per
  (video, ROI), failures isolated per video.

The JAX package's spatial sharding (``spatial``, ``halo``) splits frames
across chips; a 1080p frame fits one H100, so it has no counterpart here.
"""
