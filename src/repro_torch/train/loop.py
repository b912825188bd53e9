"""Training loop substrate: loss, train_step factory, checkpointed driver
(counterpart of ``repro/train/loop.py``).

The paper is inference-only; training here is framework substrate on float
weights (bf16 or f32). The step is eager: ``loss.backward()`` on detached
copies of the params' leaves (no data is copied) gives a gradient tree
shaped like the params, which ``optim/adamw.apply`` consumes, as the
reference's ``jax.value_and_grad`` + ``adamw.apply`` does. With a
``compress_group`` the gradients go through the int8 group-compressed
all-reduce with error feedback (``optim/compress.py``) first.

With a ``mesh`` the step is placed (the reference's ``jit`` over
``NamedSharding``s, done by hand): each rank stores the DTensor shards of
the params and AdamW moments that ``dist/sharding.param_specs(params,
mesh, "train")`` gives it (FSDP over ``data``, Megatron-style over
``model``), gathers every leaf (``full_tensor()``, in ``tree_items``
order on every rank), runs ``value_and_grad`` on its share of the global
batch (``batch_specs``), averages the gradients over the data-parallel
axes (the int8 compressed all-reduce over one of them where asked), clips
by the global norm of the full mean, and applies AdamW to its own blocks.
Ranks along ``model`` shard storage, not compute: each computes the whole
model on its data shard.

Under ``flags.blockwise_attention`` attention runs the flash kernel (B4)
forward and its hand-written backward on the card (``kernels/ops.
FlashAttention``); ``Model.forward`` recomputes each layer in the backward
(``remat``), as the reference's ``jax.checkpoint`` does. Every config
trains: zamba2's SSD scan makes a new state each position where autograd
records (``models/ssm._ssd_scan``); rwkv6's in-place WKV scan
differentiates as an out-of-place loop does.
"""

from __future__ import annotations

import dataclasses
import math
import os
import tempfile
import time
from typing import Any, Callable

import numpy as np
import torch
import torch.distributed as dist

from repro_torch.checkpoint import ckpt
from repro_torch.core.quant import QuantizedTensor
from repro_torch.core.tree import tree_items, tree_map, tree_map_with_path
from repro_torch.dist import sharding
from repro_torch.dist.logical import axis_sizes
from repro_torch.models.registry import Model
from repro_torch.optim import adamw
from repro_torch.optim.compress import compressed_all_reduce


def lm_loss(logits: torch.Tensor, labels: torch.Tensor, ignore_id: int = -1) -> torch.Tensor:
    """Mean token cross-entropy; labels == ignore_id are masked."""
    logits = logits.to(torch.float32)
    labels = labels.to(torch.long)
    lse = torch.logsumexp(logits, dim=-1)
    gold = torch.gather(logits, -1, torch.clamp(labels, min=0)[..., None])[..., 0]
    nll = lse - gold
    mask = (labels != ignore_id).to(torch.float32)
    return torch.sum(nll * mask) / torch.clamp(torch.sum(mask), min=1.0)


def make_loss_fn(model: Model):
    def loss_fn(params, batch):
        logits = model.forward(params, batch)
        loss = lm_loss(logits, batch["labels"])
        return loss, {"loss": loss}

    return loss_fn


def value_and_grad(loss_fn: Callable, params, batch):
    """((loss, aux), grads): ``loss.backward()`` on leaves that require
    grad (detached views of the params' tensors), the gradients read back
    into a tree shaped like ``params`` in each leaf's dtype (zeros for a
    leaf the loss does not reach)."""
    for path, leaf in tree_items(params):
        if isinstance(leaf, QuantizedTensor) or not leaf.is_floating_point():
            raise TypeError(f"{path}: training takes float params, got "
                            f"{type(leaf).__name__} {getattr(leaf, 'dtype', '')}")
    leaves = tree_map(lambda p: p.detach().requires_grad_(True), params)
    with torch.enable_grad():
        loss, aux = loss_fn(leaves, batch)
        loss.backward()
    grads = tree_map(lambda p: p.grad if p.grad is not None else torch.zeros_like(p), leaves)
    aux = {k: v.detach() if isinstance(v, torch.Tensor) else v for k, v in aux.items()}
    return (loss.detach(), aux), grads


def make_train_step(model: Model, opt_cfg: adamw.AdamWConfig,
                    *, compress_group=None, mesh=None) -> Callable:
    """Returns train_step(params, opt_state, batch[, residuals]).

    With ``compress_group`` (a ``torch.distributed`` process group, or
    ``"default"`` for the default group) gradients are int8-group-compressed
    with error feedback before the all-reduce, and the step takes and
    returns the residuals. With a ``mesh`` (a ``DeviceMesh``) the step is
    placed (:func:`make_placed_train_step`); ``compress_group`` is then the
    name of the mesh axis to compress over."""
    if mesh is not None:
        return make_placed_train_step(model, opt_cfg, mesh, compress_axis=compress_group)
    loss_fn = make_loss_fn(model)

    if compress_group is None:
        def train_step(params, opt_state, batch):
            (loss, aux), grads = value_and_grad(loss_fn, params, batch)
            params, opt_state, metrics = adamw.apply(opt_cfg, params, grads, opt_state)
            return params, opt_state, {**aux, **metrics}

        return train_step

    group = None if compress_group == "default" else compress_group

    def train_step(params, opt_state, batch, residuals):
        (loss, aux), grads = value_and_grad(loss_fn, params, batch)
        # the mean comes back in f32 and the update takes it so, as the
        # reference's does after its compressed psum
        grads, residuals = compressed_all_reduce(grads, group, residuals=residuals)
        params, opt_state, metrics = adamw.apply(opt_cfg, params, grads, opt_state)
        return params, opt_state, residuals, {**aux, **metrics}

    return train_step


def _mean_over(x: torch.Tensor, groups: list, n: int) -> torch.Tensor:
    """The sum of ``x`` over each process group in turn, over ``n``."""
    if n == 1:
        return x
    x = x.clone()
    for g in groups:
        dist.all_reduce(x, op=dist.ReduceOp.SUM, group=g)
    return x / n


def make_placed_train_step(model: Model, opt_cfg: adamw.AdamWConfig, mesh,
                           *, compress_axis: str | None = None) -> Callable:
    """train_step(params, opt_state, batch[, residuals]) on DTensor params
    and moments placed on ``mesh`` (``dist/sharding.distribute`` by
    ``param_specs(params, mesh, "train")``; ``adamw.init`` places the
    moments like the params). ``batch`` is the global batch, the same on
    every rank; each takes its data-parallel block. With ``compress_axis``
    (a data-parallel axis of ``mesh``, e.g. "pod") the gradients' mean over
    that axis goes through ``compressed_all_reduce`` on its group (the
    step then takes and returns each rank's residuals, full-shaped), over
    the other data-parallel axes through a plain all-reduce. On a 1 x 1
    mesh every gather is the rank's own tensor and no mean is taken, so
    the step is the unplaced one, bit for bit."""
    loss_fn = make_loss_fn(model)
    sizes = axis_sizes(mesh)
    dp = sharding.dp_axes(mesh)
    if compress_axis is not None and compress_axis not in dp:
        raise ValueError(f"compress_axis {compress_axis!r} is not a data-parallel axis of {dp}")
    plain = [a for a in dp if a != compress_axis and sizes[a] > 1]
    plain_groups = [mesh.get_group(a) for a in plain]
    n_plain = math.prod(sizes[a] for a in plain)
    dp_groups = [mesh.get_group(a) for a in dp if sizes[a] > 1]
    n_dp = math.prod(sizes[a] for a in dp)

    def grads_of(params, batch):
        full = sharding.gather(params)
        specs = sharding.batch_specs(batch, mesh)
        mine = {k: sharding.block(v, specs[k], mesh) for k, v in batch.items()}
        (loss, aux), grads = value_and_grad(loss_fn, full, mine)
        grads = tree_map(lambda g: _mean_over(g, plain_groups, n_plain), grads)
        aux = {**aux, "loss": _mean_over(loss, dp_groups, n_dp)}
        return aux, grads

    def update(params, opt_state, grads):
        grads, gnorm = adamw.clip_by_global_norm(grads, opt_cfg.grad_clip)
        flat = dict(tree_items(params))

        def mine(tree):
            return tree_map_with_path(lambda path, t: sharding.block_like(t, flat[path]), tree)

        loc = adamw.AdamWState(opt_state.step, *(tree_map(sharding.local, t)
                                                 for t in (opt_state.m, opt_state.v)))
        new_p, new_s, metrics = adamw.apply_clipped(
            opt_cfg, tree_map(sharding.local, params), mine(grads), loc, gnorm)

        def placed(tree):
            return tree_map_with_path(lambda path, t: sharding.local_like(t, flat[path]), tree)

        return placed(new_p), adamw.AdamWState(new_s.step, placed(new_s.m),
                                               placed(new_s.v)), metrics

    if compress_axis is None:
        def train_step(params, opt_state, batch):
            aux, grads = grads_of(params, batch)
            params, opt_state, metrics = update(params, opt_state, grads)
            return params, opt_state, {**aux, **metrics}

        return train_step

    group = mesh.get_group(compress_axis)

    def train_step(params, opt_state, batch, residuals):
        aux, grads = grads_of(params, batch)
        grads, residuals = compressed_all_reduce(grads, group, residuals=residuals)
        params, opt_state, metrics = update(params, opt_state, grads)
        return params, opt_state, residuals, {**aux, **metrics}

    return train_step


@dataclasses.dataclass
class LoopConfig:
    total_steps: int = 100
    ckpt_every: int = 50
    ckpt_dir: str = dataclasses.field(
        default_factory=lambda: os.path.join(tempfile.gettempdir(), "repro_torch_ckpt"))
    ckpt_keep: int = 3
    log_every: int = 10
    # straggler mitigation: steps slower than stall_factor x the rolling
    # median get flagged (on real fleets this feeds the health controller)
    stall_factor: float = 3.0


def batch_to(batch: dict, device: torch.device) -> dict:
    """A data source's numpy batch as tensors on ``device``."""
    return {k: torch.as_tensor(np.asarray(v)).to(device) for k, v in batch.items()}


def run_loop(model: Model, params, data_iter, opt_cfg: adamw.AdamWConfig,
             loop_cfg: LoopConfig, *, train_step=None, resume: bool = True,
             log: Callable[[str], None] = print):
    """Single-host driver with checkpoint/restart + straggler flagging.
    Returns (params, opt_state, history). Batches go to the device of the
    params; a step's time is taken after its loss is on the host."""
    device = tree_items(params)[0][1].device
    opt_state = adamw.init(params)
    start_step = 0
    if resume and ckpt.latest_step(loop_cfg.ckpt_dir) is not None:
        state = {"params": params, "opt": opt_state}
        state, step, extra = ckpt.restore(loop_cfg.ckpt_dir, state)
        params, opt_state = state["params"], state["opt"]
        start_step = step
        log(f"[resume] restored step {step} from {loop_cfg.ckpt_dir}")

    step_fn = train_step or make_train_step(model, opt_cfg)
    history: list[dict[str, Any]] = []
    durations: list[float] = []

    for step in range(start_step, loop_cfg.total_steps):
        batch = batch_to(data_iter.batch_at(step), device)
        t0 = time.perf_counter()
        params, opt_state, metrics = step_fn(params, opt_state, batch)
        loss, gnorm = float(metrics["loss"]), float(metrics["grad_norm"])
        dt = time.perf_counter() - t0
        durations.append(dt)
        med = sorted(durations)[len(durations) // 2]
        straggler = len(durations) > 5 and dt > loop_cfg.stall_factor * med
        rec = {"step": step + 1, "loss": loss, "grad_norm": gnorm, "sec": dt,
               "straggler": straggler}
        history.append(rec)
        if straggler:
            log(f"[straggler] step {rec['step']} took {dt:.2f}s (median {med:.2f}s)")
        if (step + 1) % loop_cfg.log_every == 0:
            log(f"step {rec['step']:5d}  loss {rec['loss']:.4f}  "
                f"gnorm {rec['grad_norm']:.3f}  {dt*1e3:.0f} ms")
        if (step + 1) % loop_cfg.ckpt_every == 0 or step + 1 == loop_cfg.total_steps:
            ckpt.save(loop_cfg.ckpt_dir, step + 1,
                      {"params": params, "opt": opt_state},
                      extra={"data_step": step + 1})
            ckpt.retain(loop_cfg.ckpt_dir, loop_cfg.ckpt_keep)

    return params, opt_state, history
