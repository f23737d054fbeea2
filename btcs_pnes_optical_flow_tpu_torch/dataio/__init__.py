"""Host-side IO: video decode + prefetch (``video``, ``codecs``, the
native loader ``native``), the reference's file contracts with pandas-free
CSV readers and writers (``contracts``) and chunk checkpoints
(``checkpoint``).

Each module is the port's own copy of its JAX-package namesake; none
imports the JAX package, pandas or cv2 unless an OpenCV decode is asked
for.
"""
