"""Training loop substrate: loss, train_step factory, checkpointed driver
(counterpart of ``repro/train/loop.py``).

The paper is inference-only; training here is framework substrate on float
weights (bf16 or f32). The step is eager: ``loss.backward()`` on detached
copies of the params' leaves (no data is copied) gives a gradient tree
shaped like the params, which ``optim/adamw.apply`` consumes, as the
reference's ``jax.value_and_grad`` + ``adamw.apply`` does. With a
``compress_group`` the gradients go through the int8 group-compressed
all-reduce with error feedback (``optim/compress.py``) first.

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
import os
import tempfile
import time
from typing import Any, Callable

import numpy as np
import torch

from repro_torch.checkpoint import ckpt
from repro_torch.core.quant import QuantizedTensor
from repro_torch.core.tree import tree_items, tree_map
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
                    *, compress_group=None) -> Callable:
    """Returns train_step(params, opt_state, batch[, residuals]).

    With ``compress_group`` (a ``torch.distributed`` process group, or
    ``"default"`` for the default group) gradients are int8-group-compressed
    with error feedback before the all-reduce, and the step takes and
    returns the residuals."""
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
