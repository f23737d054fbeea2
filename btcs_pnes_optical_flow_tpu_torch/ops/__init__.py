"""Compute primitives of the port.

``cvx`` ↔ OpenCV image ops and cv2.fillPoly, ``farneback`` ↔
calcOpticalFlowFarneback (plain PyTorch; the CUDA kernels sit behind
``farneback_cuda``), ``filters`` ↔ scipy.signal sosfiltfilt, ``pca`` ↔
the reference's sliding-window PCA.
"""
