"""Hand-written CUDA kernels: build and load (see :mod:`.build`)."""
