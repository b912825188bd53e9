"""Shared pieces of the port's training tests: one reduced config's
weights (``bridge.init_params_numpy``) and batch (``smoke_batch``) in both
packages, and the loss and gradient of one train step in each
(``jax.value_and_grad`` of the reference's ``make_loss_fn``, the port's
``train.loop.value_and_grad``), gradients keyed by tree path."""

from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import torch

from _torch_helpers import both_flags, numpy_to_jax
from repro.core.treepath import path_str
from repro.models.registry import build as jbuild
from repro.models.registry import load_config as jload
from repro.train.loop import make_loss_fn as jmake_loss_fn
from repro_torch.bridge import init_params_numpy, params_from_numpy
from repro_torch.core.tree import tree_items
from repro_torch.models.registry import build, load_config, smoke_batch
from repro_torch.train.loop import make_loss_fn, value_and_grad

# each gradient leaf within GRAD_RTOL of the reference leaf's max|g|, the
# loss within LOSS_RTOL: both f32, the same weights and batch (measured:
# <= 2.2e-6 of max|g| and <= 1.4e-7 of the loss over every trainable config)
GRAD_RTOL = 1e-5
LOSS_RTOL = 1e-6


def setup(arch: str, seed: int = 1, overrides: dict | None = None, norm_scale: float = 0.0):
    """(cfg, reference cfg, port params, reference params): ``arch``'s
    reduced config with ``overrides`` in both packages, the same weights."""
    cfg = dataclasses.replace(load_config(arch).reduced(), **(overrides or {}))
    jcfg = dataclasses.replace(jload(arch).reduced(), **(overrides or {}))
    tree = init_params_numpy(cfg, seed=seed, norm_scale=norm_scale)
    return cfg, jcfg, params_from_numpy(tree, "cpu"), numpy_to_jax(tree)


def flat(tree) -> dict[str, np.ndarray]:
    """A reference pytree's leaves by path (the port's tree paths)."""
    return {path_str(p): np.asarray(v) for p, v in jax.tree_util.tree_flatten_with_path(tree)[0]}


def both_grads(arch: str, *, blockwise: bool, batch: int = 2, seq: int = 16,
               overrides: dict | None = None, norm_scale: float = 0.0):
    """((ref loss, ref grads by path), (port loss, port grads by path)) of
    one step on ``arch``'s reduced config (with ``overrides``)."""
    cfg, jcfg, params, jparams = setup(arch, overrides=overrides, norm_scale=norm_scale)
    b = smoke_batch(cfg, batch=batch, seq=seq, seed=0)
    with both_flags(blockwise_attention=blockwise, attention_chunk=8):
        jfn = jax.jit(jax.value_and_grad(jmake_loss_fn(jbuild(jcfg)), has_aux=True))
        (jl, _), jg = jfn(jparams, {k: jnp.asarray(v) for k, v in b.items()})
        (tl, _), tg = value_and_grad(make_loss_fn(build(cfg)), params,
                                     {k: torch.as_tensor(v) for k, v in b.items()})
    return (float(jl), flat(jg)), (float(tl), {k: v.numpy() for k, v in tree_items(tg)})


def assert_grads_close(ref, port) -> None:
    (jl, jg), (tl, tg) = ref, port
    assert abs(tl - jl) <= LOSS_RTOL * abs(jl), (tl, jl)
    assert set(tg) == set(jg)
    for path, want in jg.items():
        err = np.abs(tg[path] - want).max()
        assert err <= GRAD_RTOL * np.abs(want).max(), (path, err, np.abs(want).max())
