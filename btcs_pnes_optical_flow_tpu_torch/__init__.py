"""btcs_pnes_optical_flow_tpu_torch — the PyTorch + CUDA port.

The production pipeline of ``btcs_pnes_optical_flow_tpu`` (decode →
ROI-dispatched Farnebäck flow → PC1 → metrics), its TV-L1 flow engine,
cohort runner, multi-device layer, streaming PC1 and
reference-compatible CLIs, written in
PyTorch with hand-written CUDA kernels for Hopper (``csrc/``).
The JAX package stays the reference; this package imports nothing of it
(nor jax, pandas or cv2 on its main path).

Layout
------
- ``dataio``  video sources and chunked prefetch (``video``, ``codecs``,
              ``native``), the reference's file contracts with pandas-free
              CSV readers and writers (``contracts``) and chunk
              checkpoints (``checkpoint``).
- ``ops``     compute primitives: OpenCV-exact image ops (``cvx``), the
              Farnebäck engine with ROI dispatch (``farneback``) and its
              CUDA kernels (``farneback_cuda``), the TV-L1 engine
              (``tvl1``) and its CUDA kernels (``tvl1_cuda``), both built
              by ``_build``, the NaN-robust band-pass (``filters``) and
              its design (``design``),
              sliding-window PCA (``pca``), peak detection (``peaks``) and
              rank statistics (``stats``).
- ``models``  pipeline stages: ROI flow features (``flow``), the PC1 head
              (``pc1``), the metric head (``metrics``), the end-to-end
              orchestrator (``pipeline``) and chunked PC1 (``streaming``).
- ``parallel`` one card or a mesh of them: devices over named axes
              (``mesh``), the cohort step and flow stage split over the
              mesh (``cohort``), ``run_cohort`` (``runner``), halo
              exchange (``halo``) and height-sharded Farnebäck
              (``spatial``).
- ``compat``  the reference's three scripts (optical_flow, optical_PCA,
              optical_PC1) with their call signatures and files.
- ``utils``   the device an entry point runs on (``device``), logger,
              stage timers and profiler traces (``timing``).
- ``csrc``    CUDA C++ sources of the kernels.
"""

__version__ = "0.1.0"

from btcs_pnes_optical_flow_tpu_torch.config import (  # noqa: F401
    FarnebackParams,
    MetricParams,
    PCAParams,
    PipelineConfig,
    check_supported,
)
