"""Quantization core (counterpart of ``repro.core``)."""
