"""Pipeline stages composed from ops.

- ``flow`` — dense-flow feature extraction (frame pairs → ROI-averaged
             body-axis velocities).
- ``pc1``  — band-pass + sliding-window PCA → dynamic PC1 waveform.
"""
