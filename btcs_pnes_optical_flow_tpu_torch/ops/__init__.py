"""Compute primitives of the port.

``cvx`` ↔ OpenCV image ops and cv2.fillPoly, ``farneback`` ↔
calcOpticalFlowFarneback (plain PyTorch; the CUDA kernels sit behind
``farneback_cuda``), ``tvl1`` ↔ DualTVL1 flow (kernels behind
``tvl1_cuda``), ``filters`` ↔ scipy.signal sosfiltfilt (the sequential
engine's kernel behind ``filters_cuda``), ``pca`` ↔ the
reference's sliding-window PCA, ``peaks`` / ``stats`` ↔ the metric
script's peak detection and SciPy statistics.
"""
