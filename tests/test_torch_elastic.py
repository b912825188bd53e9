"""The port's elasticity (``repro_torch/ft/elastic.py``) against the
reference's: mesh plans for 1-600 devices, the survivors of a failure, and
the elastic restart the reference runs on 8 and 4 fake devices
(``tests/test_ft_elastic.py``), here on gloo CPU ranks: reduced internlm2
trains 8 steps on 4 ranks (2 x 2, model_parallel 2) with checkpoints at 4
and 8, then resumes on 2 ranks (1 x 2) to step 12."""

from __future__ import annotations

import numpy as np
import pytest

from _torch_dist import last_json, run_ranks
from repro.ft import elastic as jelastic
from repro_torch.ft import elastic


@pytest.mark.parametrize("mp", [1, 4, 16])
def test_plan_mesh_equals_reference(mp):
    for n in range(1, 601):
        got = elastic.plan_mesh(n, model_parallel=mp)
        want = jelastic.plan_mesh(n, model_parallel=mp)
        assert (got.shape, got.axes) == (want.shape, want.axes), n
        assert int(np.prod(got.shape)) == n
    for n in (512, 520, 1024):
        got = elastic.plan_mesh(n, model_parallel=mp, multi_pod_threshold=2048)
        want = jelastic.plan_mesh(n, model_parallel=mp, multi_pod_threshold=2048)
        assert (got.shape, got.axes) == (want.shape, want.axes)


def test_survivors_after_failure_equals_reference():
    rng = np.random.default_rng(0)
    for n in (1, 2, 7, 16, 17, 33, 256, 512):
        devices = list(range(100, 100 + n))
        for _ in range(8):
            failed = set(rng.choice(n, size=rng.integers(0, n + 1), replace=False).tolist())
            assert elastic.survivors_after_failure(devices, failed) == \
                jelastic.survivors_after_failure(devices, failed), (n, failed)


TRAIN = """
from repro_torch.data.pipeline import DataConfig, SyntheticLM
from repro_torch.dist import sharding
from repro_torch.ft.elastic import elastic_mesh
from repro_torch.models.registry import build, load_config
from repro_torch.optim import adamw
from repro_torch.train.loop import LoopConfig, batch_to, make_loss_fn, make_train_step, run_loop
from repro_torch.core.tree import tensor_items

steps, ckdir = int(ARGS[0]), ARGS[1]
cfg = load_config("internlm2-1.8b").reduced()
model = build(cfg)
mesh = elastic_mesh("cpu", model_parallel=2)
params = model.init(seed=0, device="cpu")
params = sharding.distribute(params, sharding.param_specs(params, mesh, "train"), mesh)
data = SyntheticLM(DataConfig(cfg.vocab_size, 16, 4))
opt_cfg = adamw.AdamWConfig(lr=2e-3, warmup_steps=2, total_steps=12)
step_fn = make_train_step(model, opt_cfg, mesh=mesh)
seen = {}


def first_step_checks(p, o, b):
    # on the first step of a resumed run: every restored block equals the
    # block of the checkpoint's full array, bit for bit
    if not seen:
        ck = f"{ckdir}/step_{int(o.step):08d}/arrays.npz"
        saved = dict(np.load(ck)) if int(o.step) else {}
        tree = {"params": p, "opt": o}
        seen["differ"] = [k for k, t in tensor_items(tree) if k in saved and not torch.equal(
            sharding.local(t), sharding.block_like(torch.from_numpy(saved[k]), t))]
        seen["checked"] = sum(k in saved for k, _ in tensor_items(tree))
    return step_fn(p, o, b)


_, _, hist = run_loop(model, params, data, opt_cfg,
                      LoopConfig(total_steps=steps, ckpt_every=4, ckpt_dir=ckdir, log_every=100),
                      train_step=first_step_checks, log=lambda s: None)
# the fresh-init loss on the first batch this run trained on (params above
# were never updated here): the reset-detection baseline
batch = batch_to(data.batch_at(hist[0]["step"] - 1), torch.device("cpu"))
fresh = float(make_loss_fn(model)(sharding.gather(params), batch)[0])
print(json.dumps({"hist": [(h["step"], h["loss"]) for h in hist], "fresh_first_loss": fresh,
                  "mesh": list(mesh.shape), **seen}))
"""


def test_elastic_restart_reshards(tmp_path):
    ck = str(tmp_path / "elastic")
    first = [last_json(o) for o in run_ranks(TRAIN, 4, tmp_path, 8, ck, timeout=300)]
    assert all(r["mesh"] == [2, 2] for r in first)
    hist1 = first[0]["hist"]
    assert [h[0] for h in hist1] == list(range(1, 9))
    assert all(r["hist"] == hist1 for r in first)
    assert (tmp_path / "elastic" / "step_00000004").exists()
    assert (tmp_path / "elastic" / "step_00000008").exists()
    second = [last_json(o) for o in run_ranks(TRAIN, 2, tmp_path, 12, ck, timeout=300)]
    res = second[0]
    assert all(r["mesh"] == [1, 2] for r in second)
    hist2 = res["hist"]
    assert hist2[0][0] == 9 and [h[0] for h in hist2] == list(range(9, 13))
    # restored params beat a fresh re-init on the same batch: the
    # trajectory continued rather than resetting
    assert hist2[0][1] < res["fresh_first_loss"], (res["fresh_first_loss"], hist2[0])
    # every leaf of params and AdamW state restored bit for bit on both ranks
    assert all(r["differ"] == [] and r["checked"] == res["checked"] > 0 for r in second)
