"""Cohorts and frames over one card or a mesh of them.

Port of ``btcs_pnes_optical_flow_tpu/parallel``, single-controller as
there (one process drives every device):

- ``mesh``    — ``Mesh``, devices over named axes; ``make_mesh`` (the
  machine's CUDA cards), ``cohort_sharding`` and ``replicated``;
- ``cohort``  — a cohort step and a cohort's flow stage with the video axis
  split over the mesh's "data" devices, videos staged once and sliced on
  their device;
- ``runner``  — ``run_cohort``: many recordings → one metric row per
  (video, ROI), failures isolated per video;
- ``halo``    — row-halo exchange between height shards, the sharded
  window stencils;
- ``spatial`` — ``farneback_flow_sharded``: one frame's height split over
  the mesh's "spatial" devices, the port's kernels on each block.
"""
