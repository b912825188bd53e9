"""The row design of the fused RMSNorm + int8 quantize kernel
(``csrc/rmsnorm_quant.cu``, ``rmsnorm_quant_rows_kernel``): its partition
of a row over lanes, warps and a team of warps, and its order of the sum of
squares, emulated in numpy f32 on the CPU and held against the reference
package's ``rmsnorm_quant_pallas`` (interpret mode) and
``rmsnorm_quant_ref``; its constants and its choice against the first
design tied to the CUDA source (the kernel itself runs in
tests/test_torch_cuda.py and chip_smoke.py on the card).

The partition: a lane takes chunks of ``CHUNK`` consecutive elements, a
warp units of ``UNIT``; warp k of a row's team of ``plan(m, n)[0]`` warps
its units k, k + team, ... The order: each lane adds the squares of its
chunks' elements in order, starting from 0; a warp's lanes by an xor
butterfly (offsets 16, 8, 4, 2, 1); the team's warps as a pairwise tree of
8 leaves, absent warps +0. Every other rounding is the oracle's, one for
one: mean = tot / n, inv = 1 / sqrt(mean + eps), (x * inv) * w, the scale
absmax * (2 / 255), round(v / S) half to even, clipped to +-127.

Tolerance: scales within rtol 1e-5; int8 values equal to the reference's
except by one where the plain x / S lies within RMSQ_TIE (max(1e-5,
1e-6 * |x / S|)) of a .5 boundary (the sum of squares runs in another order
than the oracle's, which moves inv by an ulp; chip_smoke.RMSQ_TIE).
"""

import re
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.kernels.rmsnorm_quant import rmsnorm_quant_pallas  # noqa: E402
from repro.kernels.rmsnorm_quant import rmsnorm_quant_ref as jrmsnorm_quant_ref  # noqa: E402
from repro_torch.kernels import rmsnorm_quant as rkern  # noqa: E402

SRC = (Path(rkern.__file__).resolve().parents[1] / "csrc" / "rmsnorm_quant.cu").read_text()
EPS = 1e-5
RMSQ_TIE = (1e-5, 1e-6)
# chip_smoke.py's RMSQ_TIMED rows at TinyLlama's GS 256, then RMSQ_SWEEP's
# shape at every group size
CASES = ([(m, n, 256) for m, n in ((4, 2048), (256, 2048), (256, 5632))]
         + [(13, 1024, gs) for gs in (16, 32, 64, 128, 256)])


def rows_emulation(x: np.ndarray, w: np.ndarray, gs: int, eps: float = EPS):
    """(int8 (m, n), f32 scales (m, n / gs), the lane of every element (m, n)
    counted once per time it was taken) of the row design on f32 x, w."""
    m, n = x.shape
    team, _, _, chunks = rkern.plan(m, n)
    units = -(-n // rkern.UNIT)
    lane = np.arange(32)
    ss = np.zeros((m, team, 32), np.float32)
    taken = np.zeros((m, n), np.int64)
    for c in range(chunks):                       # a lane's chunks in order
        for k in range(team):
            u = k + c * team
            if u >= units:
                continue
            for i in range(rkern.CHUNK):          # a chunk's elements in order
                e = u * rkern.UNIT + rkern.CHUNK * lane + i
                live = e < n
                v = np.where(live, x[:, np.minimum(e, n - 1)], np.float32(0))
                ss[:, k, :] = ss[:, k, :] + v * v
                taken[:, e[live]] += 1
    for off in (16, 8, 4, 2, 1):                  # the warp's xor butterfly
        ss = ss + ss[:, :, lane ^ off]
    p = np.zeros((m, rkern.WARPS), np.float32)
    p[:, :team] = ss[:, :, 0]
    tot = ((p[:, 0] + p[:, 1]) + (p[:, 2] + p[:, 3])) + ((p[:, 4] + p[:, 5]) + (p[:, 6] + p[:, 7]))
    mean = tot / np.float32(n)
    inv = np.float32(1) / np.sqrt(mean + np.float32(eps))
    normed = (x * inv[:, None]) * w[None, :]
    g = normed.reshape(m, n // gs, gs)
    scales = np.abs(g).max(-1) * (np.float32(2) / np.float32(255))
    safe = np.where(scales > 0, scales, np.float32(1))
    q = np.clip(np.rint(g / safe[..., None]), -127, 127).astype(np.int8).reshape(m, n)
    return q, scales.astype(np.float32), taken


def _inputs(m, n, gs, dtype, seed):
    rng = np.random.default_rng(seed)
    x = torch.from_numpy((rng.normal(size=(m, n)) * 3).astype(np.float32)).to(dtype)
    x[0, :gs] = 0                                          # a group of zeros
    w = torch.from_numpy((1 + 0.1 * rng.normal(size=(n,))).astype(np.float32)).to(dtype)
    return x, w


def _assert_tie_flips_only(q, qp, sp, x32, w32, gs):
    """q equals qp except by one at values whose plain x / S lies within
    RMSQ_TIE of a .5 boundary; returns the count of flips."""
    diff = q.astype(np.int32) - qp.astype(np.int32)
    if not diff.any():
        return 0
    xt, wt = torch.from_numpy(x32), torch.from_numpy(w32)
    normed = (xt * torch.rsqrt((xt * xt).mean(-1, keepdim=True) + EPS) * wt).numpy()
    ratio = (normed.reshape(*sp.shape, gs) / np.where(sp > 0, sp, 1)[..., None]).reshape(q.shape)
    dist = np.abs(ratio - np.floor(ratio) - 0.5)
    near = dist <= np.maximum(RMSQ_TIE[1] * np.abs(ratio), RMSQ_TIE[0])
    assert np.abs(diff).max() <= 1 and near[diff != 0].all()
    return int((diff != 0).sum())


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32], ids=["bf16", "f32"])
@pytest.mark.parametrize("m,n,gs", CASES)
def test_row_design_matches_pallas_and_oracle(m, n, gs, dtype):
    assert rkern.design(n, gs) == "rows"
    x, w = _inputs(m, n, gs, dtype, seed=m + n + gs)
    x32, w32 = x.float().numpy(), w.float().numpy()
    q, s, taken = rows_emulation(x32, w32, gs)
    assert (taken == 1).all()                              # every element exactly once
    assert not q[0, :gs].any() and s[0, 0] == 0            # the zero group stays zero
    jdt = jnp.bfloat16 if dtype == torch.bfloat16 else jnp.float32
    jx, jw = jnp.asarray(x32).astype(jdt), jnp.asarray(w32).astype(jdt)
    for jq, js in (rmsnorm_quant_pallas(jx, jw, group_size=gs, interpret=True),
                   jrmsnorm_quant_ref(jx, jw, group_size=gs)):
        np.testing.assert_allclose(s, np.asarray(js), rtol=1e-5, atol=0)
        _assert_tie_flips_only(q, np.asarray(jq), np.asarray(js), x32, w32, gs)


@pytest.mark.parametrize("n", [8, 128, 1000, 2048, 2304, 5632, 12288])
def test_row_plan_takes_every_element_once_within_the_registers(n):
    """Every width the row design takes up to MAX_N: each element once, at
    most MAX_CHUNKS chunks a lane, the team the fewest warps leaving a lane
    TEAM_CHUNKS chunks (at most WARPS)."""
    team, rows, ctas, chunks = rkern.plan(5, n)
    units = -(-n // rkern.UNIT)
    assert rows * team == rkern.WARPS and ctas == -(-5 // rows)
    assert chunks <= rkern.MAX_CHUNKS
    assert team == rkern.WARPS or team * rkern.TEAM_CHUNKS >= units
    assert team == 1 or (team // 2) * rkern.TEAM_CHUNKS < units
    x = np.ones((1, n), np.float32)
    _, _, taken = rows_emulation(x, x[0], 8)
    assert (taken == 1).all()


def test_design_choice_by_pointer_and_shape():
    """The row design takes 16-byte aligned x and w with n a multiple of
    CHUNK and GS a power of two from CHUNK to UNIT; everything else the
    wrapper takes runs the first design."""
    for n, gs in ((2048, 256), (5632, 256), (1024, 16), (128, 32), (256, 8)):
        assert rkern.design(n, gs) == "rows"
        assert rkern.design(n, gs, aligned=False) == "first"
    for n, gs in ((100, 4), (1020, 4), (2048, 512), (96, 48), (12, 3)):
        assert rkern.design(n, gs) == "first"


def _cuda_int(name: str) -> int:
    return int(re.search(rf"constexpr int {name} = (\d+);", SRC).group(1))


def test_constants_mirror_the_cuda_source():
    assert _cuda_int("kThreads") == rkern.THREADS
    assert "kWarps = kThreads / 32;" in SRC and rkern.WARPS == rkern.THREADS // 32
    assert _cuda_int("kMaxN") == rkern.MAX_N
    assert _cuda_int("kChunk") == rkern.CHUNK
    assert "kUnit = 32 * kChunk;" in SRC and rkern.UNIT == 32 * rkern.CHUNK
    assert "kMaxChunks = kMaxN / (kWarps * kUnit);" in SRC
    assert rkern.MAX_CHUNKS == rkern.MAX_N // (rkern.WARPS * rkern.UNIT) == 6
    assert _cuda_int("kTeamChunks") == rkern.TEAM_CHUNKS
    # rows a CTA and shared memory: the row design's one partial a warp, the
    # first design's row as f32 (MAX_N of them fit 48 KB)
    assert "const int rows = kWarps >> lg;" in SRC
    assert "__shared__ float part[kWarps];" in SRC
    assert "<<<m, kThreads, first_smem_bytes(n), stream>>>" in SRC
    assert "first_smem_bytes(int n) { return (size_t)n * sizeof(float); }" in SRC
    assert rkern.first_smem_bytes(rkern.MAX_N) == 4 * rkern.MAX_N == 48 * 1024
    # the team: the fewest warps, at most kWarps, leaving kTeamChunks chunks a lane
    assert ("while ((1 << lg) < kWarps && ((1 << lg) * kTeamChunks) < units) ++lg;") in SRC
    # the choice by pointer and shape
    assert ("const bool aligned =\n"
            "      ((reinterpret_cast<uintptr_t>(x) | reinterpret_cast<uintptr_t>(w)) & 15) == 0;\n"
            "  return aligned && n % kChunk == 0 && gs >= kChunk && gs <= kUnit && "
            "(gs & (gs - 1)) == 0;") in SRC
