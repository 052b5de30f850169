"""Flat-bucket packing and the fused update kernels (CUDA, ``ops/csrc``)."""
