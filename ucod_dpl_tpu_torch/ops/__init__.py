"""Kernels and plain tensor ops of the PyTorch port."""
