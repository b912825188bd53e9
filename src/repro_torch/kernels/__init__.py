"""Quantized-matmul kernels and their plain versions (counterpart of ``repro.kernels``)."""
