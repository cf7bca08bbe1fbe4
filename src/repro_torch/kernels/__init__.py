"""Hand-written CUDA kernels of the port, their plain PyTorch versions and
the wrappers that dispatch between them by tensor device (``ops``).
Importing this package needs neither nvcc nor a GPU."""
