"""PyTorch/CUDA port of the DSLog lineage store (``repro``).

``repro_torch`` mirrors ``repro``'s module paths.  It imports ``torch`` and
``numpy`` and never ``jax`` or ``repro``; the kernels that ``repro`` wrote
in Pallas for the TPU are hand-written CUDA kernels for Hopper here
(``repro_torch.kernels``).  Entry points run on the GPU unless the caller
passes ``device="cpu"``.
"""
