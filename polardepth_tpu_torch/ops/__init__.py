"""Tensor ops of the port; kernels in ../csrc are built by ops/build.py."""
