"""Shared pieces of the port's training tests: one reduced config's
weights (``bridge.init_params_numpy``) and batch (``smoke_batch``) in both
packages, and the loss and gradient of one train step in each
(``jax.value_and_grad`` of the reference's ``make_loss_fn``, the port's
``train.loop.value_and_grad``), gradients keyed by tree path; the port's
gradient in float64 (``port_grads_float64``); a short AdamW loss curve in
each (``loss_curves``)."""

from __future__ import annotations

import contextlib
import dataclasses
from unittest import mock

import jax
import jax.numpy as jnp
import numpy as np
import torch

from _torch_helpers import both_flags, numpy_to_jax
from repro.core.treepath import path_str
from repro.models.registry import build as jbuild
from repro.models.registry import load_config as jload
from repro.optim import adamw as jadamw
from repro.train import loop as jloop
from repro.train.loop import make_loss_fn as jmake_loss_fn
from repro_torch.bridge import init_params_numpy, params_from_numpy
from repro_torch.configs import base as cbase
from repro_torch.core.tree import tree_items, tree_map
from repro_torch.data import pipeline
from repro_torch.models import common, rwkv, ssm
from repro_torch.models.registry import build, load_config, smoke_batch
from repro_torch.optim import adamw
from repro_torch.train import loop
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
               overrides: dict | None = None, norm_scale: float = 0.0,
               flags: dict | None = None):
    """((ref loss, ref grads by path), (port loss, port grads by path)) of
    one step on ``arch``'s reduced config (with ``overrides``), under
    ``blockwise_attention`` as given and the other ``flags`` in both
    packages."""
    cfg, jcfg, params, jparams = setup(arch, overrides=overrides, norm_scale=norm_scale)
    b = smoke_batch(cfg, batch=batch, seq=seq, seed=0)
    with both_flags(blockwise_attention=blockwise, attention_chunk=8, **(flags or {})):
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


class _Float64Torch:
    """``torch`` with ``float32`` meaning float64: put in place of the
    module name where the port casts to f32 explicitly (the scans' states,
    the norms, the loss)."""
    float32 = torch.float64

    def __getattr__(self, name):
        return getattr(torch, name)


class _NoFloat32(torch.overrides.TorchFunctionMode):
    """Raises on any float32 tensor a torch call returns: the float64 run
    carries float64 everywhere."""

    def __torch_function__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        for t in out if isinstance(out, (tuple, list)) else (out,):
            if isinstance(t, torch.Tensor) and t.dtype == torch.float32:
                raise AssertionError(f"float32 from {func} in the float64 run")
        return out


@contextlib.contextmanager
def _float64_port():
    f64 = _Float64Torch()
    with contextlib.ExitStack() as stack:
        stack.enter_context(mock.patch.dict(cbase._DTYPES, {"float32": torch.float64}))
        for mod in (common, rwkv, ssm, loop):
            stack.enter_context(mock.patch.object(mod, "torch", f64))
        stack.enter_context(_NoFloat32())
        yield


def port_grads_float64(arch: str, *, batch: int = 2, seq: int = 16,
                       overrides: dict | None = None):
    """(loss, grads by path) of the port's plain path in float64 on the
    weights and batch of ``both_grads``: the reduced config's f32 weights
    widened, every cast to f32 (config dtypes, the scans' states, the
    norms, the loss) made float64, and checked to be so."""
    cfg, _, params, _ = setup(arch, overrides=overrides)
    b = {k: torch.as_tensor(v) for k, v in smoke_batch(cfg, batch=batch, seq=seq, seed=0).items()}
    p64 = tree_map(lambda t: t.double(), params)
    with _float64_port():
        (loss, _), grads = value_and_grad(make_loss_fn(build(cfg)), p64, b)
    return float(loss), {k: v.numpy() for k, v in tree_items(grads)}


def loss_curves(arch: str, steps: int = 6, overrides: dict | None = None):
    """(port losses, reference losses) of ``steps`` AdamW steps on the
    seeded SyntheticLM stream (batch 4 x 16 tokens; lr 1e-3, warmup 2 of
    10 steps: the CLI's schedule shape) from the same weights: the port's
    ``make_train_step`` against the reference's jitted one."""
    cfg, jcfg, params, jparams = setup(arch, overrides=overrides)
    data = pipeline.SyntheticLM(pipeline.DataConfig(vocab_size=cfg.vocab_size, seq_len=16,
                                                    global_batch=4))
    opt = dict(lr=1e-3, warmup_steps=2, total_steps=10)
    step = loop.make_train_step(build(cfg), adamw.AdamWConfig(**opt))
    jstep = jax.jit(jloop.make_train_step(jbuild(jcfg), jadamw.AdamWConfig(**opt)))
    state, jstate = adamw.init(params), jadamw.init(jparams)
    got, want = [], []
    for i in range(steps):
        b = data.batch_at(i)
        params, state, m = step(params, state, loop.batch_to(b, torch.device("cpu")))
        jparams, jstate, jm = jstep(jparams, jstate, jax.tree.map(jnp.asarray, b))
        got.append(float(m["loss"]))
        want.append(float(jm["loss"]))
    return got, want
