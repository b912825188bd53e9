"""Token streams for training (counterpart of ``repro.data``)."""
