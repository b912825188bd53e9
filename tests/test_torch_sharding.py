"""The port's placement policy (``repro_torch/dist``) against the
reference's ``repro/dist`` on the same (path, shape) leaves: every
parameter leaf of the 11 configs (the reference's ``jax.eval_shape`` trees,
float and quantized at tp 16) in train and serve mode on the 16 x 16,
2 x 16 x 16, 2 x 2 and 3 x 5 (indivisible) meshes; each config's decode
caches; the batch, logits and logical-axis rules; the quantized-partition
check; and each gloo rank's DTensor block against JAX's
``devices_indices_map`` for the same device on 2 x 2 and 2 x 2 x 2."""

from __future__ import annotations

import json
from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as P

from _torch_dist import last_json, run_jax, run_ranks
from _torch_helpers import numpy_to_jax
from repro.configs.base import SHAPES as JSHAPES
from repro.core.policy import quantize_params as jquantize_params
from repro.core.quant import quantize as jquantize
from repro.core.treepath import path_str
from repro.dist import logical as jlogical
from repro.dist import sharding as jshd
from repro.models import registry as jreg
from repro_torch.bridge import init_params_numpy, params_from_numpy
from repro_torch.configs.base import SHAPES
from repro_torch.core.policy import quantize_params
from repro_torch.core.quant import quantize
from repro_torch.core.tree import tensor_items
from repro_torch.dist import logical, sharding
from repro_torch.dist.logical import MeshShape
from repro_torch.models import registry

MESHES = {
    "16x16": ((16, 16), ("data", "model")),
    "2x16x16": ((2, 16, 16), ("pod", "data", "model")),
    "2x2": ((2, 2), ("data", "model")),
    "3x5": ((3, 5), ("data", "model")),
}


def _meshes(name):
    """(the reference's SimpleNamespace mesh, the port's MeshShape)."""
    sizes, names = MESHES[name]
    return (SimpleNamespace(shape=dict(zip(names, sizes)), axis_names=names),
            MeshShape.of(sizes, names))


def _leaves(tree) -> list[tuple[str, tuple[int, ...]]]:
    return [(path_str(p), tuple(x.shape))
            for p, x in jax.tree_util.tree_flatten_with_path(tree)[0]]


_REF_TREES: dict = {}


def _ref_trees(arch: str):
    """The reference's full-size parameter tree (abstract) and its int8 PTQ
    at tp 16, in the config's format."""
    if arch not in _REF_TREES:
        cfg = jreg.load_config(arch)
        params = jax.eval_shape(jreg.build(cfg).init, jax.random.PRNGKey(0))
        q = jax.eval_shape(lambda p: jquantize_params(p, cfg.group_size, tp=16,
                                                      formats=cfg.quant_format), params)
        _REF_TREES[arch] = (params, q)
    return _REF_TREES[arch]


@pytest.mark.parametrize("arch", jreg.ARCH_IDS)
def test_param_spec_equals_reference_on_every_leaf(arch):
    params, qparams = _ref_trees(arch)
    leaves = _leaves(params) + _leaves(qparams)
    assert any(p.endswith("/scales") for p, _ in leaves)
    for mesh_name in MESHES:
        jmesh, mesh = _meshes(mesh_name)
        for mode in ("train", "serve"):
            for path, shape in leaves:
                want = tuple(jshd.param_spec(path, shape, mesh=jmesh, mode=mode))
                got = sharding.param_spec(path, shape, mesh=mesh, mode=mode)
                assert got == want, (mesh_name, mode, path, shape)


def _ref_cache(arch: str, shape_name: str):
    cfg = jreg.load_config(arch)
    return jreg.cache_specs(cfg, JSHAPES[shape_name])


@pytest.mark.parametrize("arch", jreg.ARCH_IDS)
def test_cache_specs_equal_reference_on_every_config(arch):
    """Each config's decode caches (meta tensors here, the reference's
    eval_shape there) at decode_32k (batch 128) and long_500k (batch 1):
    the same paths and shapes, and every leaf's spec."""
    cfg = registry.load_config(arch)
    for shape_name in ("decode_32k", "long_500k"):
        shape = SHAPES[shape_name]
        ref = _ref_cache(arch, shape_name)
        cache = registry.cache_specs(cfg, shape)
        assert {p: tuple(t.shape) for p, t in tensor_items(cache)} == dict(_leaves(ref))
        for mesh_name in MESHES:
            jmesh, mesh = _meshes(mesh_name)
            want = {path_str(p): tuple(s) for p, s in jax.tree_util.tree_flatten_with_path(
                jshd.cache_specs(ref, jmesh, shape.global_batch),
                is_leaf=lambda x: isinstance(x, P))[0]}
            assert sharding.cache_specs(cache, mesh, shape.global_batch) == want, mesh_name


CACHE_CASES = [
    ("k", (24, 128, 32768, 8, 128), 128),
    ("shared_k", (13, 1, 524288, 32, 112), 1),
    ("wkv", (32, 128, 64, 64, 64), 128),
    ("k", (16, 16, 32768, 8, 128), 16),       # a layer count equal to the batch
    ("conv", (4, 6, 32, 3, 288), 32),
    ("mamba/conv", (4, 32, 32, 3, 288), 32),  # per_group equal to the batch: pinned
    ("k", (2, 6, 10, 2, 8), 6),
    ("k", (2, 1, 32, 2, 8), 1),
    ("k_pages", (24, 64, 16, 8, 128), 4),
    ("k_scales", (24, 64, 16, 8), 4),
    ("pos", (8,), 8),
]


@pytest.mark.parametrize("name,shape,batch", CACHE_CASES)
def test_cache_spec_cases(name, shape, batch):
    for mesh_name in MESHES:
        jmesh, mesh = _meshes(mesh_name)
        want = tuple(jshd.cache_spec(name, shape, mesh=jmesh, batch=batch))
        assert sharding.cache_spec(name, shape, mesh=mesh, batch=batch) == want, mesh_name


def test_cache_spec_reference_cases():
    """The reference's own expectations (tests/test_distribution.py,
    tests/test_dist_edge.py), held on the port."""
    _, m16 = _meshes("16x16")
    assert sharding.cache_spec("k", (24, 128, 32768, 8, 128), mesh=m16, batch=128) == \
        (None, "data", "model", None, None)
    assert sharding.cache_spec("shared_k", (13, 1, 524288, 32, 112), mesh=m16, batch=1) == \
        (None, None, ("data", "model"), None, None)
    assert sharding.cache_spec("k", (16, 16, 32768, 8, 128), mesh=m16, batch=16) == \
        (None, "data", "model", None, None)
    assert sharding.cache_spec("conv", (4, 6, 32, 3, 288), mesh=m16, batch=32) == \
        (None, None, "data", None, None)


@pytest.mark.parametrize("mesh_name", list(MESHES))
def test_batch_and_logits_specs(mesh_name):
    jmesh, mesh = _meshes(mesh_name)
    shapes = {"tokens": (256, 4096), "odd": (3, 5), "ten": (10, 8), "pos": (), "one": (30,)}
    want = jshd.batch_specs({k: jax.ShapeDtypeStruct(s, jnp.int32) for k, s in shapes.items()},
                            jmesh)
    got = sharding.batch_specs({k: torch.empty(s, device="meta") for k, s in shapes.items()},
                               mesh)
    assert got == {k: tuple(v) for k, v in want.items()}
    for ndim, batch in ((2, 256), (3, 3), (2, 30), (3, 1)):
        assert sharding.logits_spec(mesh, ndim, batch) == tuple(
            jshd.logits_spec(jmesh, ndim, batch))
    for batch in (256, 3, 1):
        assert sharding.verify_logits_spec(mesh, batch) == tuple(
            jshd.verify_logits_spec(jmesh, batch))
    assert sharding.dp_axes(mesh) == jshd.dp_axes(jmesh)


@pytest.mark.parametrize("arch", jreg.ARCH_IDS)
def test_param_specs_over_the_ports_reduced_trees(arch):
    """The port's own trees (reduced, float and quantized at tp 2): the same
    paths, keyed, as the reference's ``param_specs`` over its trees, and
    the same specs, on 2 x 2 and 16 x 16."""
    cfg = registry.load_config(arch).reduced()
    jcfg = jreg.load_config(arch).reduced()
    tree = init_params_numpy(cfg, seed=0)
    params = params_from_numpy(tree, "cpu")
    jparams = numpy_to_jax(tree)
    pairs = [(params, jparams),
             (quantize_params(params, cfg.group_size, tp=2),
              jquantize_params(jparams, jcfg.group_size, tp=2))]
    for mesh_name in ("2x2", "16x16"):
        jmesh, mesh = _meshes(mesh_name)
        for mode in ("train", "serve"):
            for tp_tree, jtree in pairs:
                want = {path_str(p): tuple(s) for p, s in jax.tree_util.tree_flatten_with_path(
                    jshd.param_specs(jtree, jmesh, mode), is_leaf=lambda x: isinstance(x, P))[0]}
                got = sharding.param_specs(tp_tree, mesh, mode)
                assert list(got) == list(want), (mesh_name, mode)
                assert got == want, (mesh_name, mode)


def test_validate_quant_partition_passes_and_raises():
    """Each config's int8 tree at tp 16 passes on 16 x 16; a packed int4
    leaf whose groups a hand-built model axis splits raises the reference's
    message."""
    for arch in ("internlm2-1.8b", "dbrx-132b", "zamba2-7b"):
        cfg = registry.load_config(arch)
        q = quantize_params(registry.param_struct(cfg), cfg.group_size, tp=16,
                            formats=cfg.quant_format)
        sharding.validate_quant_partition(q, _meshes("16x16")[1], mode="serve")
    x = np.random.default_rng(0).normal(size=(64, 256)).astype(np.float32)
    port = {"layers": {"attn": {"wo": quantize(torch.as_tensor(x), 128, "int4")}}}
    ref = {"layers": {"attn": {"wo": jquantize(jnp.asarray(x), 128, "int4")}}}
    jmesh = SimpleNamespace(shape={"data": 1, "model": 4}, axis_names=("data", "model"))
    mesh = MeshShape.of((1, 4), ("data", "model"))
    with pytest.raises(ValueError) as want:
        jshd.validate_quant_partition(ref, jmesh, mode="serve")
    with pytest.raises(ValueError) as got:
        sharding.validate_quant_partition(port, mesh, mode="serve")
    assert str(got.value) == str(want.value)
    assert "splits quantization groups of 64 storage elements" in str(got.value)
    sharding.validate_quant_partition(port, MeshShape.of((1, 2), ("data", "model")))


def test_logical_spec_and_size_on_and_off_mesh():
    for name in ("dp", "tp", "seq"):
        assert logical.size(name) == jlogical.size(name) == 1
    assert logical.active_mesh() is None
    assert logical.spec((3, 4), "dp", "tp") == (None, None)
    x = torch.ones(4, 4)
    assert logical.constrain(x, "dp", "tp") is x
    cases = [((32, 7, 64), ("dp", "tp", "tp")), ((1, 512), (None, "seq")), ((8,), ("seq",)),
             ((32, 64), ("tp", "dp")), ((48, 64, 5), ("seq", "dp", "tp")), ((16,), ("bogus",))]
    for mesh_name in MESHES:
        jmesh, mesh = _meshes(mesh_name)
        with jlogical.use_mesh_rules(jmesh), logical.use_mesh_rules(mesh):
            assert logical.active_mesh() is mesh
            for name in ("dp", "tp", "seq"):
                assert logical.size(name) == jlogical.size(name), (mesh_name, name)
            for shape, axes in cases:
                assert logical.spec(shape, *axes) == tuple(jlogical.spec(shape, *axes)), \
                    (mesh_name, shape, axes)
            with logical.use_mesh_rules(_meshes("2x2")[1]):
                assert logical.size("seq") == 4
            assert logical.size("seq") == jlogical.size("seq")
            assert logical.constrain(x, "dp", "tp") is x
            with pytest.raises(ValueError):
                logical.constrain(torch.ones(4), "dp", "tp")
    assert logical.active_mesh() is None and logical.size("seq") == 1


# ---------------------------------------------------------------------------
# DTensor blocks against JAX's devices_indices_map
# ---------------------------------------------------------------------------

BLOCK_CASES = {
    "2x2": ((2, 2), ("data", "model"), [
        ((8, 6), ("data", "model")), ((8, 6), ("model", "data")),
        ((8, 6), (("data", "model"), None)), ((4, 8), (None, ("data", "model"))),
        ((2, 4, 6), (None, "data", "model")), ((4, 6), ("data", None)), ((4, 6), (None, None)),
    ]),
    "2x2x2": ((2, 2, 2), ("pod", "data", "model"), [
        ((8, 6), (("pod", "data"), "model")), ((16, 2), (("pod", "data", "model"), None)),
        ((6, 8), ("model", ("pod", "data"))), ((4, 4, 4), ("pod", "data", "model")),
        ((4, 6), (("data", "model"), None)), ((4, 6), ("pod", None)),
    ]),
}

JAX_BLOCKS = """
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P
sizes, names, cases = json.loads(ARGS[0])
mesh = Mesh(np.array(jax.devices()[:N_DEVICES]).reshape(sizes), tuple(names))
out = []
for shape, spec in cases:
    spec = P(*[tuple(e) if isinstance(e, list) else e for e in spec])
    idx = NamedSharding(mesh, spec).devices_indices_map(tuple(shape))
    out.append([[[s.start or 0, s.stop if s.stop is not None else n]
                 for s, n in zip(idx[d], shape)] for d in mesh.devices.flat])
print(json.dumps(out))
"""

RANK_BLOCKS = """
from repro_torch.dist import sharding
from torch.distributed.device_mesh import init_device_mesh
sizes, names, cases, want = json.loads(ARGS[0])
mesh = init_device_mesh("cpu", tuple(sizes), mesh_dim_names=tuple(names))
for (shape, spec), blocks in zip(cases, want):
    spec = tuple(tuple(e) if isinstance(e, list) else e for e in spec)
    full = torch.arange(int(np.prod(shape)), dtype=torch.float32).reshape(shape)
    dt = sharding.place(full, spec, mesh)
    sl = tuple(slice(a, b) for a, b in blocks[RANK])
    assert torch.equal(dt.to_local(), full[sl]), (RANK, shape, spec)
    assert torch.equal(dt.full_tensor(), full), (RANK, shape, spec)
    assert list(dt.placements) == sharding.placements(spec, mesh)
print(json.dumps({"rank": RANK, "cases": len(cases)}))
"""


@pytest.mark.parametrize("mesh_name", list(BLOCK_CASES))
def test_dtensor_blocks_equal_jax_device_blocks(mesh_name, tmp_path):
    sizes, names, cases = BLOCK_CASES[mesh_name]
    world = int(np.prod(sizes))
    want = json.loads(run_jax(JAX_BLOCKS, world, json.dumps([sizes, names, cases]),
                              timeout=300).strip().splitlines()[-1])
    outs = run_ranks(RANK_BLOCKS, world, tmp_path, json.dumps([sizes, names, cases, want]),
                     timeout=300)
    assert [last_json(o)["rank"] for o in outs] == list(range(world))
