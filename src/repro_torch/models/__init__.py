"""Model code (counterpart of ``repro.models``)."""
