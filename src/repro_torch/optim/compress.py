"""Group-wise int8 gradient compression with error feedback (counterpart of
``repro/optim/compress.py``).

The weights' int8 scheme (Eq. 1) applied to gradients in flight: each
leaf's last axis is split into groups, each group quantized symmetrically
to int8 with an f32 scale (absmax x 2/255, a true division, round half to
even, clamp +-127: ``core/quant._group_quantize``, bit for bit the
reference's), and the quantization error of a step is kept and added back
before the next compression [Seide et al. 2014 1-bit SGD lineage]. Each
rank contributes its dequantized int8 gradient to a sum over a
``torch.distributed`` process group (the reference's ``psum`` over a mesh
axis); leaves whose trailing dim is not group-divisible (norms, biases,
0-d) are averaged uncompressed.
"""

from __future__ import annotations

import torch
import torch.distributed as dist

from repro_torch.core.quant import DEFAULT_GROUP_SIZE, _group_quantize
from repro_torch.core.tree import tree_items, tree_map_with_path


def _groupable(leaf: torch.Tensor, group_size: int) -> bool:
    return leaf.ndim >= 1 and leaf.shape[-1] % group_size == 0


def compress_leaf(g: torch.Tensor, group_size: int = DEFAULT_GROUP_SIZE):
    """-> (int8 qvalues shaped like g, f32 scales (..., n / group_size));
    groups along the last axis."""
    return _group_quantize(g, group_size, qmax=127)


def decompress_leaf(q: torch.Tensor, scales: torch.Tensor,
                    group_size: int = DEFAULT_GROUP_SIZE) -> torch.Tensor:
    gg = q.reshape(*q.shape[:-1], q.shape[-1] // group_size, group_size)
    return (gg.to(torch.float32) * scales[..., None]).reshape(q.shape)


def _all_reduce_sum(x: torch.Tensor, group) -> torch.Tensor:
    x = x.clone()
    dist.all_reduce(x, op=dist.ReduceOp.SUM, group=group)
    return x


def compressed_all_reduce(grads, group=None, group_size: int = DEFAULT_GROUP_SIZE,
                          residuals=None):
    """Error-feedback int8-group-quantized all-reduce over ``group`` (a
    ``torch.distributed`` process group; None: the default group).

    Returns (mean_grads f32, new_residuals f32), trees shaped like
    ``grads``; ``residuals`` None means zeros."""
    n = dist.get_world_size(group)
    flat_r = dict(tree_items(residuals)) if residuals is not None else {}
    out = {}
    for path, g in tree_items(grads):
        g32 = g.to(torch.float32)
        if not _groupable(g, group_size):
            out[path] = (_all_reduce_sum(g32, group) / n, torch.zeros_like(g32))
            continue
        r = flat_r.get(path)
        if r is not None:
            g32 = g32 + r
        q, s = compress_leaf(g32, group_size)
        local = decompress_leaf(q, s, group_size)
        residual = g32 - local                      # error feedback
        out[path] = (_all_reduce_sum(local, group) / n, residual)
    return (tree_map_with_path(lambda path, _: out[path][0], grads),
            tree_map_with_path(lambda path, _: out[path][1], grads))
