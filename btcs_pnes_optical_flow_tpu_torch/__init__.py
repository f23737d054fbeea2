"""btcs_pnes_optical_flow_tpu_torch — the PyTorch + CUDA port.

The production pipeline of ``btcs_pnes_optical_flow_tpu`` (decode →
ROI-dispatched Farnebäck flow → PC1 → metrics) and its TV-L1 flow engine,
written in PyTorch with hand-written CUDA kernels for Hopper (``csrc/``).
The JAX package stays the reference; this package imports nothing of it
(nor jax, pandas or cv2 on its main path).

Layout
------
- ``dataio``  video sources and chunked prefetch (``video``, ``codecs``),
              the reference's file contracts with pandas-free CSV writers
              (``contracts``) and chunk checkpoints (``checkpoint``).
- ``ops``     compute primitives: OpenCV-exact image ops (``cvx``), the
              Farnebäck engine with ROI dispatch (``farneback``) and its
              CUDA kernels (``farneback_cuda``), the TV-L1 engine
              (``tvl1``) and its CUDA kernels (``tvl1_cuda``), both built
              by ``_build``, the NaN-robust band-pass (``filters``) and
              its design (``design``),
              sliding-window PCA (``pca``), peak detection (``peaks``) and
              rank statistics (``stats``).
- ``models``  pipeline stages: ROI flow features (``flow``), the PC1 head
              (``pc1``), the metric head (``metrics``) and the end-to-end
              orchestrator (``pipeline``).
- ``utils``   logger, stage timers and profiler traces (``timing``).
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
