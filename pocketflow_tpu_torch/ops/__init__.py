"""Compression ops and their CUDA kernels."""
