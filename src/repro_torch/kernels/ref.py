"""Plain PyTorch versions of the GQMV/GQMM kernels (paper Algorithm 1).

Counterpart of ``repro/kernels/ref.py`` (``gqmv_ref``, ``gqmm_ref``) and
the yardstick the CUDA kernels in ``csrc/gqmm.cu`` are held to:

  for each output row i:
    for each group j (of GS columns):
      group_sum = sum_k  xq[j*GS+k] * wq[i, j*GS+k]        # exact integer
      out[i]   += scaled(group_sum, ws[i, j], xs[j])       # f32

The group sums are formed in f32, on the CPU and on the card alike: every
product is at most 127^2 and every partial sum at most 127^2 * 256 < 2^24,
so each is an integer f32 holds exactly, in any summation order (and TF32,
whose 10-bit mantissa holds int8 values exactly, would not change them
either; callers that time it still turn TF32 off). ``torch.matmul`` has no
int32 kernel on CUDA, which is why the reference's int32 einsum becomes an
f32 one here. The f32 scaling keeps the oracle's association,
``(group_sums * ws) * xs``, for both shapes.
"""

from __future__ import annotations

import torch


def gqmv_ref(
    wq: torch.Tensor,   # int8 (m, n)
    ws: torch.Tensor,   # float32 (m, n // GS)
    xq: torch.Tensor,   # int8 (n,)
    xs: torch.Tensor,   # float32 (n // GS,)
    *,
    group_size: int,
) -> torch.Tensor:
    """out[m] = GQMV(W, x) per paper Alg. 1. Returns float32 (m,)."""
    m, n = wq.shape
    ng = n // group_size
    wg = wq.reshape(m, ng, group_size).to(torch.float32)
    xg = xq.reshape(ng, group_size).to(torch.float32)
    group_sums = torch.einsum("mgk,gk->mg", wg, xg)             # exact (m, ng)
    scaled = group_sums * ws * xs[None, :]
    return scaled.sum(dim=-1)


def gqmm_ref(
    wq: torch.Tensor,   # int8 (m, n)
    ws: torch.Tensor,   # float32 (m, n // GS)
    xq: torch.Tensor,   # int8 (b, n)
    xs: torch.Tensor,   # float32 (b, n // GS)
    *,
    group_size: int,
) -> torch.Tensor:
    """Batched GQMV: out[b, m]. Returns float32 (b, m)."""
    m, n = wq.shape
    b = xq.shape[0]
    ng = n // group_size
    wg = wq.reshape(m, ng, group_size).to(torch.float32)
    xg = xq.reshape(b, ng, group_size).to(torch.float32)
    group_sums = torch.einsum("mgk,bgk->bmg", wg, xg)           # exact (b, m, ng)
    scaled = group_sums * ws[None] * xs[:, None, :]
    return scaled.sum(dim=-1)
