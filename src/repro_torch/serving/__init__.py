"""Serving (counterpart of ``repro.serving``)."""
