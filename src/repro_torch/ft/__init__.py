"""Fault tolerance and elasticity (counterpart of ``repro.ft``)."""
