"""The benchmark's plain reference: Farnebäck flow and ROI features in
PyTorch (``farneback``), the PC1 and metric heads in NumPy/SciPy
(``pc1_metrics``), ROI masks (``roi``).  It imports nothing of the
program under test."""
