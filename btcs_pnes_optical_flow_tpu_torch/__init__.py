"""btcs_pnes_optical_flow_tpu_torch — the PyTorch + CUDA port.

The same flow + PC1 main path as ``btcs_pnes_optical_flow_tpu`` and its
TV-L1 flow engine, written in PyTorch with hand-written CUDA kernels for
Hopper (``csrc/``).  The JAX package stays the reference; this package
never imports JAX.

Layout
------
- ``ops``     compute primitives: OpenCV-exact image ops (``cvx``), the
              Farnebäck engine (``farneback``) and its CUDA kernels
              (``farneback_cuda``), the TV-L1 engine (``tvl1``) and its
              CUDA kernels (``tvl1_cuda``), both built by ``_build``, the
              NaN-robust band-pass (``filters``) and sliding-window PCA
              (``pca``).
- ``models``  pipeline stages: ROI flow features (``flow``) and the PC1
              head (``pc1``).
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
