"""Hand-written CUDA kernels for Hopper and their plain PyTorch versions.

``range_join`` holds the two range-join kernels of the DSLog query path
(sources in ``csrc/``, built by ``_build``), ``ref`` their plain versions,
``ops`` the numpy-facing wrappers and ``autotune`` the launch-geometry
table.  Nothing here builds or touches the GPU at import time.
"""
