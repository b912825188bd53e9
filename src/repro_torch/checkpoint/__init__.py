"""Atomic checkpoints (counterpart of ``repro.checkpoint``)."""
