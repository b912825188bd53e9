"""Shared helpers for the port's parity tests (``tests/test_torch_*.py``).

The two packages exchange parameters as nested dicts of numpy arrays, the
form ``repro_torch.bridge.params_from_numpy`` reads; these helpers convert
the reference's pytrees (with ``QuantizedTensor`` leaves) to and from it.
The perf-variant flags are separate globals in the two packages;
``both_flags`` sets a variant in both. Importing it sets PyTorch's
intra-op threads to one (see below).
"""

from __future__ import annotations

import contextlib

import jax.numpy as jnp
import numpy as np
import torch

from repro.core import flags as jflags
from repro.core.quant import QuantizedTensor as JQT
from repro_torch.core import flags as tflags

# The suite runs one pytest process per core (pytest-xdist): a process's
# own intra-op threads would only contend with the other processes for
# the same cores (every test module is imported in every process, so this
# holds for all of them). The port's CPU tests take no speed from them.
torch.set_num_threads(1)


def jax_to_numpy(tree):
    """Reference params -> nested dicts of numpy arrays (bridge format)."""
    if isinstance(tree, dict):
        return {k: jax_to_numpy(v) for k, v in tree.items()}
    if isinstance(tree, JQT):
        return {"qvalues": np.asarray(tree.qvalues), "scales": np.asarray(tree.scales),
                "group_size": tree.group_size, "fmt": tree.fmt}
    return np.asarray(tree)


def numpy_to_jax(tree):
    """Bridge-format numpy dicts -> reference params."""
    if isinstance(tree, dict):
        if {"qvalues", "scales", "group_size"} <= set(tree):
            return JQT(jnp.asarray(tree["qvalues"]), jnp.asarray(tree["scales"]),
                       int(tree["group_size"]), tree.get("fmt", "int8"))
        return {k: numpy_to_jax(v) for k, v in tree.items()}
    return jnp.asarray(tree)



@contextlib.contextmanager
def both_flags(**kw):
    """Enter ``flags.overrides(**kw)`` in the reference and in the port."""
    with jflags.overrides(**kw), tflags.overrides(**kw):
        yield
