"""Pipeline stages composed from ops.

- ``flow`` — dense-flow feature extraction (frame pairs → ROI-averaged
             body-axis velocities).
- ``pc1``  — band-pass + sliding-window PCA → dynamic PC1 waveform.
- ``metrics`` — PC1 waveform → AUC / amplitude-decay slope / Kendall τ.
- ``chunks`` — the flow stage's chunk driver (copy, launch, read-back).
- ``pipeline`` — video → flow features → PC1 → metrics (``run_full``).
- ``streaming`` — overlap-save chunked PC1 for long recordings.
"""
