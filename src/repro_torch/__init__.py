"""PyTorch/CUDA port of the ``repro`` package, slice by slice.

Imports ``torch`` and never JAX or the reference package.  Entry points
(``Model``, ``ContinuousBatchScheduler``, ``serve_poisson``) run on the
card unless the caller passes ``device="cpu"``.  Kernels are hand-written
CUDA under ``kernels/csrc/``, built with nvcc at first use.
"""
