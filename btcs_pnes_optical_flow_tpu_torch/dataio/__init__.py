"""Host-side IO: video decode + prefetch (``video``) and the body-axis
``Skeleton`` of the reference's file contracts (``contracts``).

The JAX package's jax-free readers (``VideoSource``, ``Y4MSource``,
``NpyGraySource``, ``ChunkPrefetcher``, ``codecs``, ``checkpoint``) are
imported, not copied.  This package neither needs pandas nor cv2 unless
a CSV or an OpenCV decode is asked for.
"""
