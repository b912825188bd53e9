"""The port's training path against the reference on the CPU: the data
pipeline, AdamW (schedule, clipping, one update), the int8 gradient
compression with error feedback, the losses, one train step's loss and
gradients on reduced TinyLlama (with and without ``blockwise_attention``),
a 6-step loss curve, the autograd flash attention, the refusal of
quantized params and the train CLI. Tolerances are stated in each test."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import torch.distributed as dist  # noqa: E402

from _torch_train import assert_grads_close, both_grads, flat, loss_curves, setup  # noqa: E402
from repro.data import pipeline as jpipe  # noqa: E402
from repro.models import mlp as jmlp  # noqa: E402
from repro.optim import adamw as jadamw  # noqa: E402
from repro.optim import compress as jcompress  # noqa: E402
from repro.train import loop as jloop  # noqa: E402
from repro_torch.core import flags  # noqa: E402
from repro_torch.core.tree import tree_items  # noqa: E402
from repro_torch.data import pipeline  # noqa: E402
from repro_torch.kernels import ops, ref  # noqa: E402
from repro_torch.launch import train as train_cli  # noqa: E402
from repro_torch.models import mlp  # noqa: E402
from repro_torch.models.registry import build, load_config, smoke_batch  # noqa: E402
from repro_torch.optim import adamw, compress  # noqa: E402
from repro_torch.train import loop  # noqa: E402


# ---------------------------------------------------------------------------
# data
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("seed,step,hosts,host", [(0, 0, 1, 0), (3, 5, 1, 0), (3, 5, 2, 1),
                                                  (7, 123, 4, 2)])
def test_synthetic_batches_equal_reference(seed, step, hosts, host):
    """Array for array: the same tokens and labels for every seed, step
    and host shard."""
    kw = dict(vocab_size=1000, seq_len=12, global_batch=8, seed=seed, num_hosts=hosts,
              host_index=host)
    got = pipeline.SyntheticLM(pipeline.DataConfig(**kw)).batch_at(step)
    want = jpipe.SyntheticLM(jpipe.DataConfig(**kw)).batch_at(step)
    assert set(got) == set(want)
    for k in want:
        assert got[k].dtype == want[k].dtype
        np.testing.assert_array_equal(got[k], want[k])


def test_byte_corpus_and_make_source_equal_reference():
    text = bytes(range(256)) * 3
    cfg = dict(vocab_size=256, seq_len=10, global_batch=4, seed=2)
    for step in (0, 9):
        got = pipeline.make_source("bytes", pipeline.DataConfig(**cfg), text).batch_at(step)
        want = jpipe.make_source("bytes", jpipe.DataConfig(**cfg), text).batch_at(step)
        for k in want:
            np.testing.assert_array_equal(got[k], want[k])
    first = next(iter(pipeline.make_source("synthetic", pipeline.DataConfig(**cfg))))
    np.testing.assert_array_equal(first["tokens"], jpipe.SyntheticLM(
        jpipe.DataConfig(**cfg)).batch_at(0)["tokens"])
    with pytest.raises(ValueError, match="shorter"):
        pipeline.ByteCorpus(b"abc", pipeline.DataConfig(**cfg))


# ---------------------------------------------------------------------------
# AdamW
# ---------------------------------------------------------------------------

def test_schedule_equals_reference():
    """Warmup and cosine decay at every phase, within 1e-6 of lr."""
    for cfg in (dict(lr=1.0, warmup_steps=10, total_steps=100, min_lr_ratio=0.1),
                dict(lr=3e-4, warmup_steps=1, total_steps=8)):
        for step in (0, 1, 3, 5, 7, 8, 10, 50, 99, 100, 150):
            got = float(adamw.schedule(adamw.AdamWConfig(**cfg), torch.tensor(step)))
            want = float(jadamw.schedule(jadamw.AdamWConfig(**cfg), jnp.int32(step)))
            assert abs(got - want) <= 1e-6 * cfg["lr"], (cfg, step, got, want)


def _tree(rng, dtype=np.float32, scale=1.0):
    return {"w": (rng.normal(size=(4, 64)) * scale).astype(dtype),
            "b": (rng.normal(size=(64,)) * scale).astype(dtype),
            "layers": {"x": (rng.normal(size=(2, 8, 16)) * scale).astype(dtype)}}


def _torch_tree(tree):
    return {k: _torch_tree(v) if isinstance(v, dict) else torch.as_tensor(v)
            for k, v in tree.items()}


def _jax_tree(tree):
    return jax.tree.map(jnp.asarray, tree)


@pytest.mark.parametrize("max_norm", [0.5, 1e3])
def test_clip_by_global_norm_equals_reference(max_norm):
    """The norm and every clipped leaf within 1e-6 relative (clipping and
    not)."""
    g = _tree(np.random.default_rng(0), scale=3.0)
    got, gn = adamw.clip_by_global_norm(_torch_tree(g), max_norm)
    want, wn = jadamw.clip_by_global_norm(_jax_tree(g), max_norm)
    assert abs(float(gn) - float(wn)) <= 1e-6 * float(wn)
    wflat = flat(want)
    for path, leaf in tree_items(got):
        np.testing.assert_allclose(leaf.numpy(), wflat[path], rtol=1e-6, atol=1e-7)
    assert abs(float(adamw.global_norm(got)) - float(jadamw.global_norm(want))) <= 1e-6 * max(
        1.0, float(wn))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_adamw_apply_equals_reference(dtype):
    """Two updates from init: params, m and v, the step and the metrics.
    f32: within 1e-6 relative and 1e-8 absolute (the same f32 arithmetic,
    ops fused differently); bf16 params (the clipped gradient cast back to
    bf16, the update rounded to bf16): the params within one bf16 ulp."""
    rng = np.random.default_rng(1)
    p0, g1, g2 = _tree(rng), _tree(rng, scale=2.0), _tree(rng, scale=0.5)
    tdt = getattr(torch, dtype)
    jdt = getattr(jnp, dtype)
    tp = {k: v.to(tdt) for k, v in tree_items(_torch_tree(p0))}
    tp = {"w": tp["w"], "b": tp["b"], "layers": {"x": tp["layers/x"]}}
    jp = jax.tree.map(lambda a: jnp.asarray(a).astype(jdt), p0)
    cfg = dict(lr=1e-2, warmup_steps=1, total_steps=10, weight_decay=0.1, grad_clip=1.0)
    ts, js = adamw.init(tp), jadamw.init(jp)
    for g in (g1, g2):
        tg = {k: v.to(tdt) if v.is_floating_point() else v for k, v in tree_items(_torch_tree(g))}
        tg = {"w": tg["w"], "b": tg["b"], "layers": {"x": tg["layers/x"]}}
        tp, ts, tm = adamw.apply(adamw.AdamWConfig(**cfg), tp, tg, ts)
        jp, js, jm = jadamw.apply(jadamw.AdamWConfig(**cfg), jp,
                                  jax.tree.map(lambda a: jnp.asarray(a).astype(jdt), g), js)
    assert int(ts.step) == int(js.step) == 2 and ts.step.dtype == torch.int32
    for k in ("grad_norm", "lr"):
        assert abs(float(tm[k]) - float(jm[k])) <= 1e-6 * abs(float(jm[k]))
    jpf = {k: np.asarray(jnp.asarray(v, jnp.float32)) for k, v in flat(jp).items()}
    for path, leaf in tree_items(tp):
        assert leaf.dtype == tdt
        got = leaf.float().numpy()
        if dtype == "float32":
            np.testing.assert_allclose(got, jpf[path], rtol=1e-6, atol=1e-8)
        else:
            np.testing.assert_array_less(np.abs(got - jpf[path]),
                                         2.0 ** -7 * np.abs(jpf[path]) + 1e-30)
    for name, tree, jtree in (("m", ts.m, js.m), ("v", ts.v, js.v)):
        jf = flat(jtree)
        for path, leaf in tree_items(tree):
            assert leaf.dtype == torch.float32, name
            np.testing.assert_allclose(leaf.numpy(), jf[path], rtol=1e-5, atol=1e-9)


# ---------------------------------------------------------------------------
# gradient compression
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("gs", [32, 64, 256])
def test_compress_leaf_equals_reference(gs):
    """q bit for bit, scales equal, zero groups included; decompress
    equal."""
    g = np.random.default_rng(gs).normal(size=(6, 512)).astype(np.float32) * 3
    g[2, :gs] = 0.0
    q, s = compress.compress_leaf(torch.as_tensor(g), gs)
    jq, js = jcompress.compress_leaf(jnp.asarray(g), gs)
    assert q.dtype == torch.int8 and tuple(q.shape) == g.shape
    np.testing.assert_array_equal(q.numpy(), np.asarray(jq))
    np.testing.assert_array_equal(s.numpy(), np.asarray(js))
    np.testing.assert_array_equal(compress.decompress_leaf(q, s, gs).numpy(),
                                  np.asarray(jcompress.decompress_leaf(jq, js, gs)))


@pytest.fixture
def one_process_group(tmp_path):
    """A one-process gloo group over a FileStore (no socket)."""
    store = dist.FileStore(str(tmp_path / "store"), 1)
    dist.init_process_group("gloo", store=store, rank=0, world_size=1)
    try:
        yield dist.group.WORLD
    finally:
        dist.destroy_process_group()


def test_compressed_all_reduce_equals_reference_psum(one_process_group):
    """Two rounds with error feedback on a one-process group against the
    reference's compressed_psum under shard_map on a 1-device mesh: the
    means and residuals bit for bit; leaves that do not divide into groups
    averaged uncompressed with zero residual."""
    from jax.sharding import Mesh, PartitionSpec as P
    try:
        from jax import shard_map
    except ImportError:
        from jax.experimental.shard_map import shard_map

    rng = np.random.default_rng(4)
    rounds = [{"w": rng.normal(size=(4, 512)).astype(np.float32),
               "odd": rng.normal(size=(3, 100)).astype(np.float32),
               "v": rng.normal(size=(256,)).astype(np.float32)} for _ in range(2)]
    mesh = Mesh(np.array(jax.devices()[:1]), ("pod",))
    jfirst = shard_map(lambda g: jcompress.compressed_psum(g, "pod"), mesh=mesh,
                       in_specs=(P(),), out_specs=(P(), P()))
    jnext = shard_map(lambda g, r: jcompress.compressed_psum(g, "pod", residuals=r), mesh=mesh,
                      in_specs=(P(), P()), out_specs=(P(), P()))
    tres = jres = None
    for i, g in enumerate(rounds):
        tout, tres = compress.compressed_all_reduce(_torch_tree(g), one_process_group,
                                                    residuals=tres)
        jout, jres = (jfirst(_jax_tree(g)) if i == 0 else jnext(_jax_tree(g), jres))
        for tt, jt in ((tout, jout), (tres, jres)):
            jf = flat(jt)
            for path, leaf in tree_items(tt):
                np.testing.assert_array_equal(leaf.numpy(), jf[path])
        assert not tres["odd"].any()
        assert tres["w"].abs().max() > 0


# ---------------------------------------------------------------------------
# losses
# ---------------------------------------------------------------------------

def test_lm_loss_equals_reference():
    """Masked mean cross-entropy within 1e-6 relative; the reference's own
    uniform case (log V)."""
    rng = np.random.default_rng(5)
    logits = (rng.normal(size=(3, 7, 50)) * 4).astype(np.float32)
    labels = rng.integers(0, 50, size=(3, 7)).astype(np.int32)
    labels[1, 3:] = -1
    got = float(loop.lm_loss(torch.as_tensor(logits), torch.as_tensor(labels)))
    want = float(jloop.lm_loss(jnp.asarray(logits), jnp.asarray(labels)))
    assert abs(got - want) <= 1e-6 * abs(want)
    uniform = loop.lm_loss(torch.zeros((2, 3, 8)), torch.tensor([[1, 2, 3], [4, -1, -1]]))
    assert abs(float(uniform) - np.log(8)) <= 1e-6


def test_moe_aux_loss_equals_reference():
    """dbrx's reduced router on random activations: within 1e-6."""
    cfg, jcfg, params, jparams = setup("dbrx-132b")
    x = np.random.default_rng(6).normal(size=(2, 9, cfg.d_model)).astype(np.float32)
    p = {"router_w": params["layers"]["mlp"]["router_w"][0]}
    jp = {"router_w": jparams["layers"]["mlp"]["router_w"][0]}
    got = float(mlp.moe_aux_loss(p, torch.as_tensor(x), cfg))
    want = float(jmlp.moe_aux_loss(jp, jnp.asarray(x), jcfg))
    assert abs(got - want) <= 1e-6 * abs(want)


# ---------------------------------------------------------------------------
# the train step
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("blockwise", [False, True])
def test_tinyllama_loss_and_gradients_equal_reference(blockwise):
    """Reduced TinyLlama f32: the loss and every gradient leaf against
    jax.value_and_grad(make_loss_fn(model)) (each leaf within 1e-5 of the
    reference leaf's max|g|, the loss 1e-6 relative); under the flag the
    port's plain flash backward against XLA's gradient of _mha_blockwise."""
    assert_grads_close(*both_grads("tinyllama-1.1b", blockwise=blockwise))


def test_tinyllama_six_step_loss_curve_equals_reference():
    """Six AdamW steps on the seeded SyntheticLM stream (the CLI's lr
    schedule shape, lr 1e-3): every loss within 1e-4 relative of the
    reference's jitted train step."""
    got, want = loss_curves("tinyllama-1.1b")
    np.testing.assert_allclose(got, want, rtol=1e-4)


def test_train_step_refuses_quantized_params():
    from repro_torch.core.policy import quantize_params

    cfg, _, params, _ = setup("tinyllama-1.1b")
    b = loop.batch_to(smoke_batch(cfg, seq=8), torch.device("cpu"))
    step = loop.make_train_step(build(cfg), adamw.AdamWConfig())
    with pytest.raises(TypeError, match="float params"):
        step(quantize_params(params, cfg.group_size), adamw.init(params), b)


# ---------------------------------------------------------------------------
# the autograd flash attention
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("causal,window,softcap", [(True, None, None), (True, 6, 5.0),
                                                   (False, None, None), (False, 5, 3.0)])
def test_flash_attention_autograd_on_cpu_is_the_plain_backward(causal, window, softcap):
    """With grad on, ops.flash_attention goes through FlashAttention: its
    gradients are flash_attention_bwd_ref's exactly, and within 1e-5 of
    max|g| of autograd through the plain forward; with grad off the output
    is the plain forward's bit for bit."""
    rng = np.random.default_rng(7)
    q, do = (torch.as_tensor(rng.normal(size=(8, 21, 32)).astype(np.float32)) for _ in range(2))
    k, v = (torch.as_tensor(rng.normal(size=(2, 21, 32)).astype(np.float32)) for _ in range(2))
    kw = dict(group=4, scale=32 ** -0.5, causal=causal, window=window, softcap=softcap)
    leaves = [x.clone().requires_grad_(True) for x in (q, k, v)]
    with flags.overrides(attention_chunk=8):
        out = ops.flash_attention(*leaves, **kw)
        assert type(out.grad_fn).__name__ == "FlashAttentionBackward"
        got = torch.autograd.grad(out, leaves, do)
        _, lse = ref.flash_attention_ref(q, k, v, return_lse=True, **kw)
        want = ref.flash_attention_bwd_ref(q, k, v, out.detach(), lse, do, **kw)
        auto = torch.autograd.grad(ref.flash_attention_ref(*leaves, **kw), leaves, do)
        with torch.no_grad():
            assert torch.equal(ops.flash_attention(q, k, v, **kw),
                               ref.flash_attention_ref(q, k, v, **kw))
    for g, w, a in zip(got, want, auto):
        assert torch.equal(g, w)
        assert (g - a).abs().max() <= 1e-5 * a.abs().max()


def test_blockwise_attention_gives_wqkv_a_gradient():
    """Under blockwise_attention every layer's wqkv (which reaches the loss
    only through attention) gets a nonzero gradient, as without the flag."""
    cfg, _, params, _ = setup("tinyllama-1.1b")
    b = loop.batch_to(smoke_batch(cfg, seq=16), torch.device("cpu"))
    loss_fn = loop.make_loss_fn(build(cfg))
    with flags.overrides(blockwise_attention=True):
        _, grads = loop.value_and_grad(loss_fn, params, b)
    _, plain = loop.value_and_grad(loss_fn, params, b)
    for lp in range(cfg.num_layers):
        g = grads["layers"]["attn"]["wqkv"][lp]
        assert g.abs().amax(dim=1).gt(0).all()      # every output row of q, k and v
        assert (g - plain["layers"]["attn"]["wqkv"][lp]).abs().max() <= 1e-5 * g.abs().max()


def test_backward_and_train_step_bounds_from_tinyllama_shapes():
    """The bounds phase 11 prints: B4's backward at 1 x 2048 is five
    products of 2 hd operations over the causal pairs, bound by the bf16
    rate; a train step moves each of TinyLlama's 1,100,048,384 parameters
    as bf16 param and gradient, f32 m and v (read and written)."""
    from repro_torch.kernels import bounds

    cfg = load_config("tinyllama-1.1b")
    bwd = bounds.flash_backward(cfg, 1, 2048)
    assert bwd.ops == 10 * 64 * 32 * 2048 * 2049 // 2 and bwd.bound_by == "operations"
    assert bwd.ops == 5 * bounds.flash_prefill(cfg, 1, 2048).ops // 2
    assert bwd.nbytes == 2 * (4 * 32 * 2048 * 64 + 4 * 4 * 2048 * 64) + 4 * 32 * 2048
    step = bounds.train_step(cfg, 8, 128)
    assert step.nbytes == 24 * 1_100_048_384 and step.bound_by == "operations"
    assert bounds.train_step(cfg, 8, 128, "f32").nbytes == 32 * 1_100_048_384


# ---------------------------------------------------------------------------
# the train CLI
# ---------------------------------------------------------------------------

def test_train_cli_runs_reduced_on_cpu(tmp_path, capsys):
    hist = train_cli.main(["--arch", "tinyllama-1.1b", "--reduced", "--steps", "2", "--batch",
                           "2", "--seq", "16", "--device", "cpu", "--ckpt-dir",
                           str(tmp_path / "ck")])
    out = capsys.readouterr().out
    assert "device: cpu" in out and f"final loss: {hist[-1]['loss']:.4f}" in out
    assert [h["step"] for h in hist] == [1, 2]
    assert (tmp_path / "ck" / "step_00000002" / "arrays.npz").exists()


def test_train_cli_default_device_needs_cuda(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("the default device is the card here")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        train_cli.main(["--arch", "tinyllama-1.1b", "--reduced", "--steps", "1", "--ckpt-dir",
                        str(tmp_path / "ck")])

