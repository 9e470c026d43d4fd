"""PyTorch/CUDA port of meta_interpolation_tpu for NVIDIA Hopper.

The JAX package beside it stays the reference; this package imports
nothing of it. See README.md, section "PyTorch / H100 port".
"""
