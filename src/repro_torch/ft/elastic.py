"""Fault tolerance and elasticity (counterpart of ``repro/ft/elastic.py``).

  failure                    mechanism here
  -------------------------- ----------------------------------------------
  host or rank loss mid-run  atomic checkpoints (checkpoint/ckpt.py) written
                             from gathered leaves, and ``elastic_mesh()``
                             over the ranks that are still alive; restore
                             places the full arrays on the new mesh
  slow straggler step        rolling-median step-time flagging in
                             train/loop.py
  data loss on restart       the data iterator's state is the integer step
                             in the checkpoint manifest (exact resume)
  slow cross-group link      int8 group gradient compression
                             (optim/compress.py) over one mesh axis

The placement rules name axes (dist/sharding.py), never device counts, so
any mesh with the same axis names places the same tree.

A mesh here is a ``torch.distributed`` ``DeviceMesh`` over the current
process group's ranks. A process with no process group gets a one-rank
group on an in-memory store, so a single-process run needs no launcher;
under a launcher (``WORLD_SIZE`` > 1 in the environment) the group is
initialised from the environment, and a missing rendezvous raises: a
requested world is never quietly cut to one rank.
"""

from __future__ import annotations

import dataclasses
import math
import os

import torch
import torch.distributed as dist

from repro_torch.device import resolve_device


@dataclasses.dataclass(frozen=True)
class MeshPlan:
    shape: tuple[int, ...]
    axes: tuple[str, ...]


def plan_mesh(num_devices: int, *, model_parallel: int = 16,
              multi_pod_threshold: int = 512) -> MeshPlan:
    """A (pod, data, model) factorization of whatever devices remain:
    model_parallel is capped at the device count's gcd with it, data
    absorbs the rest, and a pod axis appears only with enough devices for
    two pods."""
    mp = math.gcd(model_parallel, num_devices)
    rest = num_devices // mp
    if num_devices >= multi_pod_threshold and rest % 2 == 0:
        return MeshPlan((2, rest // 2, mp), ("pod", "data", "model"))
    return MeshPlan((rest, mp), ("data", "model"))


def survivors_after_failure(devices, failed_indices: set[int]):
    """The devices left after losing ``failed_indices``, cut to the largest
    count with a clean (data, model) factorization (tests)."""
    alive = [d for i, d in enumerate(devices) if i not in failed_indices]
    n = len(alive)
    while n > 0 and math.gcd(n, 16) not in (1, 2, 4, 8, 16):
        n -= 1
    return alive[:n]


def _backend(device: torch.device) -> str:
    return "nccl" if device.type == "cuda" else "gloo"


def _select_card(dev: torch.device) -> None:
    """On CUDA, each rank takes the card of its local rank (0 alone)."""
    if dev.type == "cuda":
        torch.cuda.set_device(int(os.environ.get("LOCAL_RANK", "0")))


def ensure_process_group(device="cuda") -> bool:
    """Initialise the default process group if there is none: from the
    environment under a launcher (``WORLD_SIZE`` > 1), else one rank on a
    ``HashStore``. Returns True where this call made the group (the caller
    destroys it)."""
    dev = resolve_device(device)
    if dist.is_initialized():
        return False
    world = int(os.environ.get("WORLD_SIZE", "1"))
    _select_card(dev)
    if world > 1:
        dist.init_process_group(_backend(dev), init_method="env://")
    else:
        dist.init_process_group(_backend(dev), store=dist.HashStore(), rank=0, world_size=1)
    return True


def elastic_mesh(device="cuda", **kw):
    """The best ``DeviceMesh`` over the current process group's ranks
    (``plan_mesh(world, **kw)``), on ``device``'s type (CUDA unless the
    caller asks for the CPU); a process group is made first where there is
    none (``ensure_process_group``)."""
    from torch.distributed.device_mesh import init_device_mesh

    dev = resolve_device(device)
    ensure_process_group(dev)
    _select_card(dev)
    plan = plan_mesh(dist.get_world_size(), **kw)
    return init_device_mesh(dev.type, plan.shape, mesh_dim_names=plan.axes)
