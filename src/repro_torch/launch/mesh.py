"""Production and host meshes (counterpart of ``repro/launch/mesh.py``).

Functions, not module constants: importing this module touches no device
or process group.
"""

from __future__ import annotations

import math

import torch.distributed as dist

from repro_torch.dist.logical import MeshShape


def make_production_mesh(*, multi_pod: bool = False, device="cuda"):
    """16 x 16 = 256 chips a pod; 2 pods = 512 chips, the reference's
    production meshes. Axes: data (DP/FSDP), model (TP/EP/SP), and the
    leading pod axis. The shape-only description (``MeshShape``), unless
    the current process group has exactly that many ranks: then a
    ``DeviceMesh`` over them on ``device``'s type."""
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    if dist.is_initialized() and dist.get_world_size() == math.prod(shape):
        from torch.distributed.device_mesh import init_device_mesh

        return init_device_mesh(str(device).split(":")[0], shape, mesh_dim_names=axes)
    return MeshShape.of(shape, axes)


def make_host_mesh(device="cuda"):
    """Whatever ranks exist right now (``ft.elastic.elastic_mesh``): a
    single process gets 1 x 1 (the one card of this machine)."""
    from repro_torch.ft.elastic import elastic_mesh

    return elastic_mesh(device)
