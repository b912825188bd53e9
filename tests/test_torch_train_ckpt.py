"""Checkpoints and resume on the CPU: the reference's layout (step
directories written atomically, ``arrays.npz`` under tree paths, the
manifest), retention and the newest step, the refusal of a quantization
mismatch, bf16 / fp16 / fp8 leaves round-tripping bit for bit (where the
reference's own restore of a bf16 leaf fails), a reference-written f32
checkpoint restoring into the port's tree, and ``run_loop``'s resume equal
bit for bit to a straight run."""

import json
import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from _torch_train import setup  # noqa: E402
from repro.checkpoint import ckpt as jckpt  # noqa: E402
from repro.optim import adamw as jadamw  # noqa: E402
from repro_torch.checkpoint import ckpt  # noqa: E402
from repro_torch.core.quant import QuantizedTensor, quantize  # noqa: E402
from repro_torch.core.tree import tree_items  # noqa: E402
from repro_torch.data.pipeline import DataConfig, SyntheticLM  # noqa: E402
from repro_torch.models.registry import build  # noqa: E402
from repro_torch.optim import adamw  # noqa: E402
from repro_torch.train.loop import LoopConfig, run_loop  # noqa: E402


def _state(dtype=torch.float32):
    g = torch.Generator().manual_seed(0)
    params = {"w": torch.randn((3, 4), generator=g).to(dtype),
              "nested": {"b": torch.randn((5,), generator=g).to(dtype)}}
    opt = adamw.init(params)
    opt = adamw.AdamWState(step=torch.tensor(7, dtype=torch.int32),
                           m={"w": torch.randn((3, 4), generator=g),
                              "nested": {"b": torch.randn((5,), generator=g)}},
                           v=opt.v)
    return {"params": params, "opt": opt}


def _bits_equal(a, b) -> bool:
    if a.dtype != b.dtype or a.shape != b.shape:
        return False
    if a.is_floating_point() and a.element_size() in (1, 2):
        view = torch.int16 if a.element_size() == 2 else torch.uint8
        return torch.equal(a.view(view), b.view(view))
    return torch.equal(a, b)


def test_checkpoint_round_trip_keeps_the_reference_layout(tmp_path):
    state = _state()
    d = str(tmp_path / "ck")
    final = ckpt.save(d, 7, state, extra={"data_step": 7})
    assert os.path.basename(final) == "step_00000007" and not os.path.exists(f"{d}/tmp.7")
    manifest = json.loads(open(os.path.join(final, ckpt.MANIFEST)).read())
    assert {"step", "keys", "extra", "quant", "format"} <= set(manifest)
    assert manifest["keys"] == sorted(["params/w", "params/nested/b", "opt/step", "opt/m/w",
                                       "opt/m/nested/b", "opt/v/w", "opt/v/nested/b"])
    assert manifest["step"] == 7 and manifest["extra"] == {"data_step": 7}
    assert set(np.load(os.path.join(final, ckpt.ARRAYS)).files) == set(manifest["keys"])
    like = {"params": {"w": torch.zeros(3, 4), "nested": {"b": torch.zeros(5)}},
            "opt": adamw.init({"w": torch.zeros(3, 4), "nested": {"b": torch.zeros(5)}})}
    out, step, extra = ckpt.restore(d, like)
    assert step == 7 and extra == {"data_step": 7}
    assert isinstance(out["opt"], adamw.AdamWState) and out["opt"].step.dtype == torch.int32
    got, want = dict(tree_items(out["params"])), dict(tree_items(state["params"]))
    assert all(torch.equal(got[k], want[k]) for k in want)
    assert torch.equal(out["opt"].m["w"], state["opt"].m["w"]) and int(out["opt"].step) == 7
    with pytest.raises(ValueError, match="shape mismatch"):
        ckpt.restore(d, {**like, "params": {"w": torch.zeros(4, 3),
                                            "nested": {"b": torch.zeros(5)}}})


def test_checkpoint_retention_and_latest(tmp_path):
    d = str(tmp_path / "ck")
    assert ckpt.latest_step(d) is None
    with pytest.raises(FileNotFoundError):
        ckpt.restore(d, {"x": torch.zeros(2)})
    for s in (1, 2, 3, 4):
        ckpt.save(d, s, {"x": torch.ones(2) * s})
    os.makedirs(os.path.join(d, "tmp.5"))            # an interrupted write is no checkpoint
    ckpt.retain(d, keep=2)
    assert ckpt.latest_step(d) == 4
    assert sorted(n for n in os.listdir(d) if n.startswith("step_")) == [
        "step_00000003", "step_00000004"]
    out, step, _ = ckpt.restore(d, {"x": torch.zeros(2)}, step=3)
    assert step == 3 and torch.equal(out["x"], torch.full((2,), 3.0))


def test_checkpoint_refuses_a_quantization_mismatch(tmp_path):
    w = torch.randn(4, 64, generator=torch.Generator().manual_seed(1))
    d = str(tmp_path / "ck")
    ckpt.save(d, 1, {"w": quantize(w, 32, "int8")})
    manifest = json.loads(open(os.path.join(d, "step_00000001", ckpt.MANIFEST)).read())
    assert manifest["quant"] == {"w": {"fmt": "int8", "group_size": 32}}
    assert manifest["keys"] == ["w/qvalues", "w/scales"]
    out, _, _ = ckpt.restore(d, {"w": quantize(torch.zeros(4, 64), 32, "int8")})
    assert isinstance(out["w"], QuantizedTensor) and torch.equal(
        out["w"].qvalues, quantize(w, 32, "int8").qvalues)
    for like in (quantize(torch.zeros(4, 64), 32, "int4"),
                 quantize(torch.zeros(4, 64), 64, "int8")):
        with pytest.raises(ValueError, match="quantization mismatch"):
            ckpt.restore(d, {"w": like})


def test_low_precision_leaves_round_trip_bit_exactly(tmp_path):
    """bf16 and fp16 params (NaN, inf, -0 and subnormal patterns included),
    fp8 quantized values and an f32 AdamW state come back with the same
    bits, on a meta-tensor restore target too."""
    state = _state(torch.bfloat16)
    like_opt = adamw.init(state["params"])
    w = state["params"]["w"].view(torch.int16)
    w[0, :4] = torch.tensor([0x7FC1, 0x7F80, -32768, 0x0001], dtype=torch.int16)
    state["params"]["half"] = torch.randn(6).half()
    state["params"]["fp8"] = quantize(torch.randn(2, 32), 16, "fp8")
    d = str(tmp_path / "ck")
    ckpt.save(d, 3, state)
    manifest = json.loads(open(os.path.join(d, "step_00000003", ckpt.MANIFEST)).read())
    assert manifest["dtypes"]["params/w"] == "bfloat16"
    assert manifest["dtypes"]["params/half"] == "float16"
    assert manifest["dtypes"]["params/fp8/qvalues"] == "float8_e4m3fn"
    like = {"params": {k: (v.to("meta") if isinstance(v, torch.Tensor) else v)
                       for k, v in state["params"].items()},
            "opt": like_opt}
    like["params"]["nested"] = {"b": state["params"]["nested"]["b"].to("meta")}
    out, _, _ = ckpt.restore(d, like)
    got, want = dict(tree_items(out["params"])), dict(tree_items(state["params"]))
    assert set(got) == set(want)
    for k in want:
        if isinstance(want[k], QuantizedTensor):
            assert _bits_equal(got[k].qvalues, want[k].qvalues)
            assert torch.equal(got[k].scales, want[k].scales)
        else:
            assert got[k].device.type == "cpu" and _bits_equal(got[k], want[k]), k
    assert torch.equal(out["opt"].m["w"], state["opt"].m["w"])


def test_reference_restore_fails_on_the_bf16_tree_the_port_restores(tmp_path):
    """The same bf16 tree: the reference's save writes the leaf as a 2-byte
    void array its own restore cannot cast back; the port's save and
    restore give the same bits."""
    bits = np.random.default_rng(2).integers(-2 ** 15, 2 ** 15, size=(3, 4), dtype=np.int16)
    bits[(bits & 0x7F80) == 0x7F80] = 0                     # no NaN / inf patterns
    tree = torch.from_numpy(bits).view(torch.bfloat16)
    jtree = jnp.asarray(np.asarray(tree.float().numpy()), jnp.bfloat16)
    assert np.array_equal(np.asarray(jtree).view(np.int16), bits)
    jd = str(tmp_path / "ref")
    jckpt.save(jd, 1, {"w": jtree})
    with pytest.raises(ValueError, match="cast"):
        jckpt.restore(jd, {"w": jtree})
    d = str(tmp_path / "port")
    ckpt.save(d, 1, {"w": tree})
    out, _, _ = ckpt.restore(d, {"w": torch.zeros((3, 4), dtype=torch.bfloat16)})
    assert _bits_equal(out["w"], tree)


def test_reference_f32_checkpoint_restores_into_the_port_tree(tmp_path):
    """The reference's run_loop state (params and AdamWState after one
    update, reduced TinyLlama, f32) saved by the reference restores into the
    port's tree: every leaf equal, the step an int32."""
    cfg, jcfg, params, jparams = setup("tinyllama-1.1b")
    grads = jax.tree.map(lambda p: jnp.full_like(p, 1e-3), jparams)
    jp, js, _ = jadamw.apply(jadamw.AdamWConfig(), jparams, grads, jadamw.init(jparams))
    d = str(tmp_path / "ref")
    jckpt.save(d, 1, {"params": jp, "opt": js}, extra={"data_step": 1})
    out, step, extra = ckpt.restore(d, {"params": params, "opt": adamw.init(params)})
    assert step == 1 and extra == {"data_step": 1}
    for name, tree, jtree in (("params", out["params"], jp), ("m", out["opt"].m, js.m),
                              ("v", out["opt"].v, js.v)):
        jflat = {"/".join(str(getattr(k, "key", k)) for k in path): np.asarray(v)
                 for path, v in jax.tree_util.tree_flatten_with_path(jtree)[0]}
        for path, leaf in tree_items(tree):
            np.testing.assert_array_equal(leaf.numpy(), jflat[path], err_msg=f"{name}/{path}")
    assert out["opt"].step.dtype == torch.int32 and int(out["opt"].step) == 1


def test_run_loop_resume_is_bit_equal_to_a_straight_run(tmp_path):
    """4 steps (checkpoints at 2 and 4), then a run to 6 from the same
    directory: its history starts at step 5, and its losses, grad norms and
    final params and AdamW state equal a straight 6-step run's bit for bit."""
    cfg, _, params, _ = setup("tinyllama-1.1b")
    model = build(cfg)
    data = SyntheticLM(DataConfig(vocab_size=cfg.vocab_size, seq_len=16, global_batch=4))
    opt = adamw.AdamWConfig(lr=1e-3, warmup_steps=2, total_steps=10)

    def lc(total, name):
        return LoopConfig(total_steps=total, ckpt_every=2, ckpt_dir=str(tmp_path / name),
                          log_every=100)

    logs = []
    run_loop(model, params, data, opt, lc(4, "run"), log=logs.append)
    p2, o2, hist2 = run_loop(model, params, data, opt, lc(6, "run"), log=logs.append)
    assert [h["step"] for h in hist2] == [5, 6]
    assert logs == [f"[resume] restored step 4 from {tmp_path / 'run'}"]
    p3, o3, hist3 = run_loop(model, params, data, opt, lc(6, "straight"), resume=False,
                             log=logs.append)
    for a, b in zip(hist2, hist3[4:]):
        assert (a["step"], a["loss"], a["grad_norm"]) == (b["step"], b["loss"], b["grad_norm"])
    for x, y in ((p2, p3), (o2.m, o3.m), (o2.v, o3.v)):
        fy = dict(tree_items(y))
        assert all(torch.equal(v, fy[k]) for k, v in tree_items(x))
    assert int(o2.step) == int(o3.step) == 6
    assert ckpt.latest_step(str(tmp_path / "run")) == 6
