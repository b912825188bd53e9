"""The training loop (counterpart of ``repro.train``)."""
