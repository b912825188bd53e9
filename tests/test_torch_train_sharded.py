"""The placed train step (``train/loop.make_placed_train_step``) on gloo
CPU ranks against the port's unplaced step on the same global batches and
against the reference's sharded step (``jit`` over ``NamedSharding``s) on
a 2 x 2 mesh of fake host devices; the compressed all-reduce inside it;
and one rank, where the placed step is the unplaced one bit for bit.

Tolerances. The placed step's gradient is the mean of the data ranks'
half-batch gradients where the unplaced step takes the full batch's at
once, and XLA's partitioned step sums in its own order: f32 reordering.
- The first step's AdamW moments hold the clipped gradient (m = 0.1 g,
  v = 0.05 g^2): each leaf within GRAD_RTOL (1e-5, the port's gradient
  rule, ``tests/_torch_train.py``) of its max|.|, v at twice that (a
  square doubles a relative error).
- Losses and grad norms over the steps within CURVE_RTOL, the loss-curve
  rule of ``test_torch_train.py`` (1e-4).
- Parameters after the steps within PARAM_RTOL (1e-3) of a leaf's max|.|:
  AdamW divides each gradient element by its own magnitude, so a
  reordering that flips a near-zero element moves that weight by up to lr
  a step; the reference's own 2 x 2 step leaves its one-device step by
  1.16e-4 of a leaf's max after these 3 steps, and the port's unplaced
  step the reference's by 1.80e-4 (measured).
The measured worst errors are printed."""

from __future__ import annotations

import numpy as np
import pytest
import torch
import torch.distributed as dist

from _torch_dist import last_json, run_jax, run_ranks
from repro_torch.bridge import init_params_numpy, params_from_numpy
from repro_torch.core.tree import tensor_items
from repro_torch.dist import sharding
from repro_torch.ft.elastic import elastic_mesh
from repro_torch.models.registry import build, load_config, smoke_batch
from repro_torch.optim import adamw
from repro_torch.train.loop import make_train_step

ARCH = "internlm2-1.8b"
STEPS = 3
SEQ = 16
LR = 2e-3
GRAD_RTOL = 1e-5
CURVE_RTOL = 1e-4
PARAM_RTOL = 1e-3

COMMON = """
from repro_torch.bridge import init_params_numpy, params_from_numpy
from repro_torch.core.tree import tensor_items
from repro_torch.models.registry import build, load_config, smoke_batch
from repro_torch.optim import adamw


def setup(arch, steps, lr):
    cfg = load_config(arch).reduced()
    opt_cfg = adamw.AdamWConfig(lr=lr, warmup_steps=1, total_steps=steps)
    params = params_from_numpy(init_params_numpy(cfg, seed=1), "cpu")
    return cfg, build(cfg), opt_cfg, params


def batch_at(cfg, i, batch, seq):
    return {k: torch.as_tensor(v) for k, v in smoke_batch(cfg, batch=batch, seq=seq,
                                                           seed=i).items()}
"""

PLACED = COMMON + """
from repro_torch.dist import sharding
from repro_torch.ft.elastic import elastic_mesh
from repro_torch.train.loop import make_train_step

arch, steps, batch, seq, mp, lr, out = (ARGS[0], int(ARGS[1]), int(ARGS[2]), int(ARGS[3]),
                                         int(ARGS[4]), float(ARGS[5]), ARGS[6])
cfg, model, opt_cfg, params = setup(arch, steps, lr)
mesh = elastic_mesh("cpu", model_parallel=mp)
specs = sharding.param_specs(params, mesh, "train")
params = sharding.distribute(params, specs, mesh)
opt = adamw.init(params)
assert all(p.placements == m.placements
           for (_, p), (_, m) in zip(tensor_items(params), tensor_items(opt.m)))
step = make_train_step(model, opt_cfg, mesh=mesh)
hist = []
full = {}
for i in range(steps):
    params, opt, m = step(params, opt, batch_at(cfg, i, batch, seq))
    hist.append([float(m["loss"]), float(m["grad_norm"])])
    if i == 0:
        full.update({f"m1/{k}": v.numpy() for k, v in tensor_items(sharding.gather(opt.m))})
        full.update({f"v1/{k}": v.numpy() for k, v in tensor_items(sharding.gather(opt.v))})
sharded = sum(any(type(p).__name__ == "Shard" for p in t.placements)
              for _, t in tensor_items(params))
full.update({f"params/{k}": v.numpy() for k, v in tensor_items(sharding.gather(params))})
if RANK == 0:
    np.savez(out, **full)
print(json.dumps({"hist": hist, "mesh": list(mesh.shape), "sharded_leaves": sharded}))
"""

REF_SHARDED = COMMON + """
import torch
from _torch_helpers import numpy_to_jax
from repro.dist.sharding import batch_specs, param_specs, shardings
from repro.models.registry import build as jbuild, load_config as jload
from repro.optim import adamw as jadamw
from repro.train.loop import make_train_step as jmake_train_step
from repro.core.treepath import path_str
from jax.sharding import Mesh

arch, steps, batch, seq, lr, out = (ARGS[0], int(ARGS[1]), int(ARGS[2]), int(ARGS[3]),
                                     float(ARGS[4]), ARGS[5])
cfg = load_config(arch).reduced()
jcfg = jload(arch).reduced()
model = jbuild(jcfg)
mesh = Mesh(np.array(jax.devices()[:4]).reshape(2, 2), ("data", "model"))
params = numpy_to_jax(init_params_numpy(cfg, seed=1))
params = jax.device_put(params, shardings(param_specs(params, mesh, "train"), mesh))
opt = jadamw.init(params)
step = jax.jit(jmake_train_step(model, jadamw.AdamWConfig(lr=lr, warmup_steps=1,
                                                          total_steps=steps)))
hist, flat = [], {}


def keyed(prefix, tree):
    return {f"{prefix}/{path_str(p)}": np.asarray(v)
            for p, v in jax.tree_util.tree_flatten_with_path(tree)[0]}


with mesh:
    for i in range(steps):
        b = {k: jnp.asarray(v) for k, v in smoke_batch(cfg, batch=batch, seq=seq, seed=i).items()}
        b = jax.device_put(b, shardings(batch_specs(b, mesh), mesh))
        params, opt, m = step(params, opt, b)
        hist.append([float(m["loss"]), float(m["grad_norm"])])
        if i == 0:
            flat.update({**keyed("m1", opt.m), **keyed("v1", opt.v)})
flat.update(keyed("params", params))
np.savez(out, **flat)
print(json.dumps({"hist": hist}))
"""


def _unplaced(batch: int):
    """The port's unplaced step on the same weights and global batches."""
    cfg = load_config(ARCH).reduced()
    opt_cfg = adamw.AdamWConfig(lr=LR, warmup_steps=1, total_steps=STEPS)
    params = params_from_numpy(init_params_numpy(cfg, seed=1), "cpu")
    opt = adamw.init(params)
    step = make_train_step(build(cfg), opt_cfg)
    hist, flat = [], {}
    for i in range(STEPS):
        b = {k: torch.as_tensor(v) for k, v in smoke_batch(cfg, batch=batch, seq=SEQ,
                                                           seed=i).items()}
        params, opt, m = step(params, opt, b)
        hist.append([float(m["loss"]), float(m["grad_norm"])])
        if i == 0:
            flat.update({f"m1/{k}": v.numpy() for k, v in tensor_items(opt.m)})
            flat.update({f"v1/{k}": v.numpy() for k, v in tensor_items(opt.v)})
    flat.update({f"params/{k}": v.numpy() for k, v in tensor_items(params)})
    return hist, flat


def _hold(tag, hist, leaves, want_hist, want_leaves) -> None:
    """The first step's moments, the curve and the final params within the
    module's tolerances (printed: the worst of each)."""
    h, w = np.asarray(hist), np.asarray(want_hist)
    curve = float(np.max(np.abs(h - w) / np.abs(w)))
    assert curve <= CURVE_RTOL, (tag, hist, want_hist)
    assert set(leaves) == set(want_leaves), tag
    errs = {k: float(np.abs(leaves[k] - v).max() / max(np.abs(v).max(), 1e-30))
            for k, v in want_leaves.items()}
    tol = {"m1": GRAD_RTOL, "v1": 2 * GRAD_RTOL, "params": PARAM_RTOL}
    worst = {}
    for kind, t in tol.items():
        mine = {k: e for k, e in errs.items() if k.startswith(kind + "/")}
        k = max(mine, key=mine.get)
        worst[kind] = (k, mine[k])
        assert mine[k] <= t, (tag, k, mine[k], t)
    print(f"{tag}: curve within {curve:.2e}; worst " + ", ".join(
        f"{k} {e:.2e}" for k, e in worst.values()))


@pytest.mark.parametrize("batch", [4, 3])
def test_placed_step_on_2x2_matches_unplaced_and_reference(batch, tmp_path):
    """4 gloo ranks (data 2 x model 2) against the unplaced step and the
    reference's jit over NamedShardings on 2 x 2 fake devices. batch 4
    splits over data (2 rows a rank); batch 3 does not divide, so every
    rank takes the whole batch (replicated, as the reference does) and the
    mean over the data ranks equals the one-rank loss."""
    out = tmp_path / "placed.npz"
    outs = run_ranks(PLACED, 4, tmp_path, ARCH, STEPS, batch, SEQ, 2, LR, out, timeout=300)
    res = [last_json(o) for o in outs]
    assert all(r["mesh"] == [2, 2] for r in res)
    assert all(r["hist"] == res[0]["hist"] for r in res)
    assert res[0]["sharded_leaves"] > 0
    placed = dict(np.load(out))
    hist, flat = _unplaced(batch)
    _hold(f"placed vs unplaced, batch {batch}", res[0]["hist"], placed, hist, flat)
    ref_out = tmp_path / "ref.npz"
    ref = last_json(run_jax(REF_SHARDED, 4, ARCH, STEPS, batch, SEQ, LR, ref_out, timeout=600))
    _hold(f"placed vs reference sharded, batch {batch}", res[0]["hist"], placed,
          ref["hist"], dict(np.load(ref_out)))


COMPRESSED = COMMON + """
from repro_torch.dist import sharding
from repro_torch.ft.elastic import elastic_mesh
from repro_torch.train.loop import make_train_step

arch, steps, batch, seq, lr = ARGS[0], int(ARGS[1]), int(ARGS[2]), int(ARGS[3]), float(ARGS[4])
cfg, model, opt_cfg, init = setup(arch, steps, lr)
mesh = elastic_mesh("cpu", model_parallel=1)
placed = sharding.distribute(init, sharding.param_specs(init, mesh, "train"), mesh)
popt, params, opt = adamw.init(placed), init, adamw.init(init)
pstep = make_train_step(model, opt_cfg, mesh=mesh, compress_group="data")
step = make_train_step(model, opt_cfg, compress_group="default")
pres = res = None
for i in range(steps):
    b = batch_at(cfg, i, batch, seq)
    placed, popt, pres, pm = pstep(placed, popt, b, pres)
    mine = {k: v[RANK * batch // WORLD:(RANK + 1) * batch // WORLD] for k, v in b.items()}
    params, opt, res, m = step(params, opt, mine, res)
    pl, l = float(pm["loss"]), float(m["loss"])
    t = torch.tensor([l])
    dist.all_reduce(t)
    assert float(pm["grad_norm"]) == float(m["grad_norm"]), i
    assert abs(pl - float(t[0]) / WORLD) <= 1e-6 * abs(pl), (i, pl, float(t[0]) / WORLD)
full = sharding.gather(placed)
diff = [k for k, v in tensor_items(params) if not torch.equal(dict(tensor_items(full))[k], v)]
diff += [k for k, v in tensor_items(res) if not torch.equal(dict(tensor_items(pres))[k], v)]
print(json.dumps({"differ": diff}))
"""


def test_placed_compressed_step_equals_the_unplaced_compressed_step(tmp_path):
    """2 ranks (data 2, model 1; FSDP shards every matrix over data) with
    the int8 compressed all-reduce over the data axis, against the
    unplaced compressed step on the same 2 ranks, each fed its half of the
    batch: params and residuals bit-equal (the update is elementwise on
    each rank's block), grad norms equal, the loss the ranks' mean."""
    outs = run_ranks(COMPRESSED, 2, tmp_path, ARCH, STEPS, 4, SEQ, LR, timeout=300)
    assert all(last_json(o)["differ"] == [] for o in outs)


def test_one_rank_placed_step_is_bit_equal(tmp_path):
    """A one-rank group (the card's case): the 1 x 1 mesh replicates every
    leaf, and three placed steps equal the unplaced ones bit for bit:
    losses, grad norms, params, moments."""
    dist.init_process_group("gloo", store=dist.FileStore(str(tmp_path / "store"), 1),
                            rank=0, world_size=1)
    try:
        mesh = elastic_mesh("cpu")
        assert dict(zip(mesh.mesh_dim_names, mesh.shape)) == {"data": 1, "model": 1}
        cfg = load_config(ARCH).reduced()
        model = build(cfg)
        opt_cfg = adamw.AdamWConfig(lr=LR, warmup_steps=1, total_steps=STEPS)
        params = params_from_numpy(init_params_numpy(cfg, seed=1), "cpu")
        specs = sharding.param_specs(params, mesh, "train")
        assert all(s == (None,) * len(s) for s in specs.values())
        placed = sharding.distribute(params, specs, mesh)
        popt, opt = adamw.init(placed), adamw.init(params)
        pstep, step = make_train_step(model, opt_cfg, mesh=mesh), make_train_step(model, opt_cfg)
        for i in range(STEPS):
            b = {k: torch.as_tensor(v) for k, v in smoke_batch(cfg, batch=4, seq=SEQ,
                                                               seed=i).items()}
            placed, popt, pm = pstep(placed, popt, b)
            params, opt, m = step(params, opt, b)
            for k in ("loss", "grad_norm", "lr"):
                assert torch.equal(pm[k], m[k]), (i, k)
        for a, b in ((placed, params), (popt.m, opt.m), (popt.v, opt.v)):
            got, want = dict(tensor_items(sharding.gather(a))), dict(tensor_items(b))
            assert all(torch.equal(got[k], v) for k, v in want.items())
        assert torch.equal(popt.step, opt.step)
    finally:
        dist.destroy_process_group()


def test_train_cli_one_process_is_bit_equal_to_the_unplaced_loop(tmp_path, capsys):
    """The train CLI with one process and no launcher: a one-rank group it
    makes and gives back, the 1 x 1 mesh, and losses and grad norms
    bit-equal to run_loop over the unplaced step on the same seed."""
    from repro_torch.data.pipeline import DataConfig, SyntheticLM
    from repro_torch.launch import train as train_cli
    from repro_torch.train.loop import LoopConfig, run_loop

    hist = train_cli.main(["--arch", ARCH, "--reduced", "--steps", "3", "--batch", "4", "--seq",
                           str(SEQ), "--device", "cpu", "--ckpt-dir", str(tmp_path / "cli"),
                           "--no-resume"])
    assert "mesh: {'data': 1, 'model': 1}" in capsys.readouterr().out
    assert not dist.is_initialized()
    cfg = load_config(ARCH).reduced()
    model = build(cfg)
    opt_cfg = adamw.AdamWConfig(lr=3e-4, total_steps=3, warmup_steps=1)
    data = SyntheticLM(DataConfig(vocab_size=cfg.vocab_size, seq_len=SEQ, global_batch=4, seed=0))
    _, _, want = run_loop(model, model.init(seed=0, device="cpu"), data, opt_cfg,
                          LoopConfig(total_steps=3, ckpt_every=50,
                                     ckpt_dir=str(tmp_path / "plain")),
                          resume=False, log=lambda _: None)
    assert [(h["loss"], h["grad_norm"]) for h in hist] == \
        [(h["loss"], h["grad_norm"]) for h in want]


def test_placed_step_refuses_a_model_compress_axis(tmp_path):
    dist.init_process_group("gloo", store=dist.FileStore(str(tmp_path / "store"), 1),
                            rank=0, world_size=1)
    try:
        mesh = elastic_mesh("cpu")
        with pytest.raises(ValueError, match="not a data-parallel axis"):
            make_train_step(build(load_config(ARCH).reduced()), adamw.AdamWConfig(),
                            mesh=mesh, compress_group="model")
    finally:
        dist.destroy_process_group()


def test_no_process_group_makes_one_rank_and_never_downgrades(monkeypatch):
    """A process with no group gets a one-rank group (and gives it back);
    under a launcher's WORLD_SIZE it rendezvouses from the environment and
    raises when that cannot happen, never cutting the world to one."""
    from repro_torch.ft import elastic

    assert not dist.is_initialized()
    assert elastic.ensure_process_group("cpu") is True
    try:
        assert dist.get_world_size() == 1
        assert elastic.ensure_process_group("cpu") is False
    finally:
        dist.destroy_process_group()
    monkeypatch.setenv("WORLD_SIZE", "4")
    monkeypatch.delenv("MASTER_ADDR", raising=False)
    monkeypatch.delenv("MASTER_PORT", raising=False)
    with pytest.raises(ValueError):
        elastic.ensure_process_group("cpu")
    assert not dist.is_initialized()
