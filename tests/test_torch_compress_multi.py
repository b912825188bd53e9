"""``optim/compress.compressed_all_reduce`` on 2 and 4 gloo CPU ranks
against the reference's ``compressed_psum`` under ``shard_map`` on as many
fake host devices: two rounds with error feedback, each rank its own
gradients. Each rank's int8 values and scales must equal the reference's
``compress_leaf`` of the same input, and its residuals the reference's
exactly (both elementwise on those values); the means may differ by the
order of an n-term f32 sum: within (n - 1) * 2^-24 * sum_i |term_i| / n of
each element, the bound of any summation order (gloo's ring against XLA's
psum). Leaves that do not divide into groups are averaged uncompressed."""

from __future__ import annotations

import numpy as np
import pytest

from _torch_dist import run_jax, run_ranks
from repro.optim import compress as jcompress

SHAPES = {"w": (4, 512), "odd": (3, 100), "v": (256,)}
GS = 256
EPS32 = 2.0 ** -24


def _grads(world: int) -> list[list[dict]]:
    """grads[round][rank]: seeded by (round, rank)."""
    return [[{k: np.random.default_rng(100 * rnd + r).normal(size=s).astype(np.float32)
              * (1 + r) for k, s in SHAPES.items()} for r in range(world)] for rnd in range(2)]


RANKS = """
from repro_torch.optim import compress
out = ARGS[0]
grads = np.load(ARGS[1])
res, saved = None, {}
for rnd in range(2):
    g = {k: torch.as_tensor(grads[f"{rnd}/{RANK}/{k}"]) for k in ("w", "odd", "v")}
    # the values this rank puts on the wire: the int8 groups of g (+ residual)
    for k in ("w", "v"):
        x = g[k] + (res[k] if res is not None else 0)
        q, s = compress.compress_leaf(x, 256)
        saved[f"{rnd}/q/{k}"], saved[f"{rnd}/s/{k}"] = q.numpy(), s.numpy()
    mean, res = compress.compressed_all_reduce(g, None, 256, residuals=res)
    for k in g:
        saved[f"{rnd}/mean/{k}"], saved[f"{rnd}/res/{k}"] = mean[k].numpy(), res[k].numpy()
np.savez(f"{out}_{RANK}.npz", **saved)
print(json.dumps({"rank": RANK}))
"""

REF = """
from jax.sharding import Mesh, PartitionSpec as P
try:
    from jax import shard_map
except ImportError:
    from jax.experimental.shard_map import shard_map
from repro.optim.compress import compressed_psum
n, src, out = N_DEVICES, np.load(ARGS[0]), ARGS[1]
mesh = Mesh(np.array(jax.devices()[:n]), ("pod",))
keys = ("w", "odd", "v")


def stacked(rnd):
    return {k: jnp.stack([src[f"{rnd}/{r}/{k}"] for r in range(n)]) for k in keys}


def first(g):
    m, r = compressed_psum({k: v[0] for k, v in g.items()}, "pod")
    return ({k: v[None] for k, v in m.items()}, {k: v[None] for k, v in r.items()})


def nxt(g, res):
    m, r = compressed_psum({k: v[0] for k, v in g.items()}, "pod",
                           residuals={k: v[0] for k, v in res.items()})
    return ({k: v[None] for k, v in m.items()}, {k: v[None] for k, v in r.items()})


spec = {k: P("pod") for k in keys}
m0, r0 = shard_map(first, mesh=mesh, in_specs=(spec,), out_specs=(spec, spec))(stacked(0))
m1, r1 = shard_map(nxt, mesh=mesh, in_specs=(spec, spec), out_specs=(spec, spec))(stacked(1), r0)
saved = {}
for rnd, (m, r) in enumerate(((m0, r0), (m1, r1))):
    for k in keys:
        saved[f"{rnd}/mean/{k}"], saved[f"{rnd}/res/{k}"] = np.asarray(m[k]), np.asarray(r[k])
np.savez(out, **saved)
print(json.dumps({"devices": n}))
"""


@pytest.mark.parametrize("world", [2, 4])
def test_compressed_all_reduce_equals_reference_psum(world, tmp_path):
    grads = _grads(world)
    src = tmp_path / "grads.npz"
    np.savez(src, **{f"{rnd}/{r}/{k}": v for rnd, per in enumerate(grads)
                     for r, g in enumerate(per) for k, v in g.items()})
    run_ranks(RANKS, world, tmp_path, tmp_path / "port", src, timeout=240)
    ref_out = tmp_path / "ref.npz"
    run_jax(REF, world, src, ref_out, timeout=300)
    ref = dict(np.load(ref_out))
    ports = [dict(np.load(tmp_path / f"port_{r}.npz")) for r in range(world)]
    for rnd in range(2):
        for r, port in enumerate(ports):
            for k in ("w", "v"):
                prev = ref[f"{rnd - 1}/res/{k}"][r] if rnd else 0
                q, s = jcompress.compress_leaf(grads[rnd][r][k] + prev, GS)
                np.testing.assert_array_equal(port[f"{rnd}/q/{k}"], np.asarray(q))
                np.testing.assert_array_equal(port[f"{rnd}/s/{k}"], np.asarray(s))
            for k in SHAPES:
                np.testing.assert_array_equal(port[f"{rnd}/res/{k}"], ref[f"{rnd}/res/{k}"][r])
                terms = np.stack([grads[rnd][i][k] + (ref[f"{rnd - 1}/res/{k}"][i] if rnd else 0)
                                  - ref[f"{rnd}/res/{k}"][i] for i in range(world)])
                bound = (world - 1) * EPS32 * np.abs(terms).sum(0) / world + 1e-30
                err = np.abs(port[f"{rnd}/mean/{k}"] - ref[f"{rnd}/mean/{k}"][r])
                assert (err <= bound).all(), (world, rnd, r, k, float((err / bound).max()))
        # every rank holds the same mean
        for k in SHAPES:
            assert all(np.array_equal(p[f"{rnd}/mean/{k}"], ports[0][f"{rnd}/mean/{k}"])
                       for p in ports)
