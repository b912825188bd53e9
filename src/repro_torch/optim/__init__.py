"""Optimizer and gradient compression (counterpart of ``repro.optim``)."""
