"""The flash-attention backward (``flash_attn_bwd``, ``csrc/flash_attn.cu``)
and the train step on the card. Every test needs a CUDA device and ``nvcc``
and skips without them; the file imports neither JAX nor the reference:

    python -m pytest -q -m cuda tests/test_torch_train_cuda.py

Tolerances: dQ, dK and dV within 1e-4 * max|plain| of the plain backward
(``kernels/ref.flash_attention_bwd_ref``) at f32 inputs (another f32 order
of every sum), and within 2e-2 * max|plain| at bf16 / fp16 inputs, where
the plain arithmetic runs in f32 on the same values (the kernel rounds each
gradient once to the input type, and its forward rounds P before P V); the
forward's log-sum-exp within 1e-5 (f32) or 1e-3 (bf16 / fp16) absolute of
the plain version's (it is a log: an absolute error).
"""

import dataclasses

import pytest

torch = pytest.importorskip("torch")

from repro_torch.bridge import init_params_numpy, params_from_numpy  # noqa: E402
from repro_torch.core import flags  # noqa: E402
from repro_torch.core.tree import tree_items, tree_map  # noqa: E402
from repro_torch.kernels import flash_attn as flash_kern  # noqa: E402
from repro_torch.kernels import ops, ref  # noqa: E402
from repro_torch.models.registry import build, load_config, smoke_batch  # noqa: E402
from repro_torch.train.loop import make_loss_fn, value_and_grad  # noqa: E402

pytestmark = pytest.mark.cuda

GRAD_TOL = {torch.float32: 1e-4, torch.bfloat16: 2e-2, torch.float16: 2e-2}
LSE_TOL = {torch.float32: 1e-5, torch.bfloat16: 1e-3, torch.float16: 1e-3}
# (b*H, b*KV, s, t, hd, causal, window, softcap)
CASES = [
    (32, 4, 128, 128, 64, True, None, None),      # TinyLlama's heads, one tile row
    (8, 2, 200, 200, 32, True, None, None),       # s not a multiple of the tiles
    (16, 4, 70, 70, 128, True, None, None),       # hd 128
    (8, 8, 130, 130, 64, True, 32, 50.0),         # window + soft cap
    (8, 4, 96, 96, 256, True, 48, 50.0),          # gemma2: hd 256, window, cap
    (8, 8, 100, 100, 112, True, None, None),      # zamba2: hd 112
    (16, 16, 96, 96, 64, False, None, None),      # seamless encoder: non-causal
    (8, 2, 40, 70, 64, False, None, 30.0),        # non-causal, t > s, soft cap
    (8, 2, 33, 33, 32, True, 5, None),            # a window narrower than a tile
    (16, 4, 150, 150, 64, True, None, None),      # s, t no multiple of 64 (ragged tiles)
    (4, 4, 130, 130, 128, True, None, None),      # group 1: no group sum, hd 128
    (16, 2, 190, 190, 64, True, None, None),      # group 8 over several key tiles
    (8, 4, 100, 100, 256, True, 20, 50.0),        # hd 256, a window narrower than a key tile
    (8, 2, 50, 130, 112, False, None, None),      # hd 112, t > s, non-causal
]


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device and nvcc (run on the GPU machine)")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda", 0)


def _inputs(dev, bh, bkv, s, t, hd, dtype, seed=0):
    g = torch.Generator(device=dev).manual_seed(seed)
    q, do = (torch.randn((bh, s, hd), generator=g, device=dev).to(dtype) for _ in range(2))
    k, v = (torch.randn((bkv, t, hd), generator=g, device=dev).to(dtype) for _ in range(2))
    return q, k, v, do


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16, torch.float16])
@pytest.mark.parametrize("bh,bkv,s,t,hd,causal,window,softcap", CASES)
def test_flash_backward_kernel_within_tolerance_of_plain(dev, dtype, bh, bkv, s, t, hd, causal,
                                                         window, softcap):
    q, k, v, do = _inputs(dev, bh, bkv, s, t, hd, dtype, seed=s + t + hd)
    kw = dict(group=bh // bkv, scale=hd ** -0.5, causal=causal, window=window, softcap=softcap)
    plain = flash_kern.flash_attention_cuda(q, k, v, **kw)
    out, lse = flash_kern.flash_attention_cuda(q, k, v, return_lse=True, **kw)
    assert torch.equal(out, plain)          # the lse pointer changes no output bit
    f32 = [x.float() for x in (q, k, v, do)]
    ref_out, ref_lse = ref.flash_attention_ref(*f32[:3], return_lse=True, **kw)
    assert (lse - ref_lse).abs().max() <= LSE_TOL[dtype]
    before = dict(flash_kern.LAUNCHES)
    got = flash_kern.flash_attention_bwd_cuda(q, k, v, out, lse, do, **kw)
    assert flash_kern.LAUNCHES == {**before, "flash_attn_bwd": before["flash_attn_bwd"] + 1}
    want = ref.flash_attention_bwd_ref(*f32[:3], ref_out, ref_lse, f32[3], **kw)
    for name, g, w in zip(("dq", "dk", "dv"), got, want):
        assert g.dtype == dtype and g.shape == w.shape, name
        err = (g.float() - w).abs().max() / w.abs().max()
        assert err <= GRAD_TOL[dtype], (name, err.item())
    again = flash_kern.flash_attention_bwd_cuda(q, k, v, out, lse, do, **kw)
    for g, a in zip(got, again):            # no atomics: the same bits every call
        assert torch.equal(g, a)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16, torch.float16])
@pytest.mark.parametrize("hd", flash_kern.HEAD_DIMS)
def test_flash_backward_layout_equals_the_mirror(dev, dtype, hd):
    """Both backward products kernels (dK/dV, dQ) of the compiled library:
    their shared memory is kernels/flash_attn.bwd_smem_bytes, and at least
    one CTA fits an SM (two for the f32 kernels at hd 32 and 64)."""
    for dq in (False, True):
        smem, ctas = flash_kern.bwd_layout(hd, dtype, dq)
        assert smem == flash_kern.bwd_smem_bytes(hd, dq, dtype), (dq, smem)
        assert ctas >= (2 if dtype == torch.float32 and hd <= 64 else 1), (dq, ctas)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16, torch.float16])
def test_flash_backward_takes_a_dout_off_16_bytes(dev, dtype):
    """A contiguous dout 8 bytes off a 16-byte boundary (an autograd
    gradient can be one) gives the same bits as an aligned copy: the
    wrapper copies it for the tensor-core kernels' 16-byte loads."""
    q, k, v, do = _inputs(dev, 8, 2, 70, 70, 64, dtype)
    kw = dict(group=4, scale=0.125)
    out, lse = flash_kern.flash_attention_cuda(q, k, v, return_lse=True, **kw)
    per = 8 // do.element_size()
    shifted = torch.empty(do.numel() + per, dtype=dtype, device=dev)[per:].view(do.shape)
    shifted.copy_(do)
    assert shifted.data_ptr() % 16 == 8
    want = flash_kern.flash_attention_bwd_cuda(q, k, v, out, lse, do, **kw)
    got = flash_kern.flash_attention_bwd_cuda(q, k, v, out, lse, shifted, **kw)
    for g, w in zip(got, want):
        assert torch.equal(g, w)


def test_autograd_function_launches_the_backward_kernel(dev):
    """With grad on, ``ops.flash_attention`` on CUDA tensors runs the
    forward kernel with its lse and the backward kernel; with grad off it is
    the forward alone."""
    q, k, v, do = _inputs(dev, 8, 2, 64, 64, 64, torch.bfloat16)
    kw = dict(group=4, scale=0.125, causal=True, window=None, softcap=None)
    flash_kern.reset_launches()
    with torch.no_grad():
        ops.flash_attention(q, k, v, **kw)
    assert flash_kern.LAUNCHES == {"flash_attn": 1, "flash_attn_f32": 0, "flash_attn_bwd": 0}
    leaves = [x.clone().requires_grad_(True) for x in (q, k, v)]
    out = ops.flash_attention(*leaves, **kw)
    out.backward(do)
    assert flash_kern.LAUNCHES == {"flash_attn": 2, "flash_attn_f32": 0, "flash_attn_bwd": 1}
    f32 = [x.float() for x in (q, k, v, do)]
    ref_out, ref_lse = ref.flash_attention_ref(*f32[:3], return_lse=True, **kw)
    want = ref.flash_attention_bwd_ref(*f32[:3], ref_out, ref_lse, f32[3], **kw)
    for leaf, w in zip(leaves, want):
        assert (leaf.grad.float() - w).abs().max() <= 2e-2 * w.abs().max()


def test_flash_backward_rejects_bad_arguments(dev):
    q, k, v, do = _inputs(dev, 8, 2, 16, 16, 32, torch.float32)
    out, lse = flash_kern.flash_attention_cuda(q, k, v, group=4, scale=0.125, return_lse=True)
    kw = dict(group=4, scale=0.125)
    with pytest.raises(ValueError, match="lse"):
        flash_kern.flash_attention_bwd_cuda(q, k, v, out, lse[:, :8], do, **kw)
    with pytest.raises(ValueError, match="dout"):
        flash_kern.flash_attention_bwd_cuda(q, k, v, out, lse, do.half(), **kw)
    with pytest.raises(ValueError, match="no visible key"):
        flash_kern.flash_attention_bwd_cuda(q, k[:, :8].contiguous(), v[:, :8].contiguous(),
                                            out, lse, do, window=4, **kw)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_train_step_gradients_kernel_against_plain(dev, dtype):
    """Reduced TinyLlama under blockwise attention: the gradients of the
    kernel path (B4 forward and backward) against the plain path's on the
    same params and batch (f32: 1e-4 of each leaf's max; bf16: 5e-2)."""
    name = "float32" if dtype == torch.float32 else "bfloat16"
    cfg = dataclasses.replace(load_config("tinyllama-1.1b").reduced(), param_dtype=name,
                              compute_dtype=name)
    model = build(cfg)
    params = tree_map(lambda p: p.to(dtype),
                      params_from_numpy(init_params_numpy(cfg, seed=1), dev))
    batch = {k: torch.as_tensor(v).to(dev) for k, v in
             smoke_batch(cfg, batch=2, seq=64, seed=0).items()}
    loss_fn = make_loss_fn(model)
    with flags.overrides(blockwise_attention=True):
        flash_kern.reset_launches()
        (loss, _), grads = value_and_grad(loss_fn, params, batch)
        counts = dict(flash_kern.LAUNCHES)
        with ops.impl_scope("plain"):
            (ploss, _), pgrads = value_and_grad(loss_fn, params, batch)
    fwd = "flash_attn_f32" if dtype == torch.float32 else "flash_attn"
    # remat recomputes every layer's forward in the backward
    assert counts[fwd] == 2 * cfg.num_layers and counts["flash_attn_bwd"] == cfg.num_layers
    tol = 1e-4 if dtype == torch.float32 else 5e-2
    assert abs(loss.item() - ploss.item()) <= tol * abs(ploss.item())
    pflat = dict(tree_items(pgrads))
    for path, g in tree_items(grads):
        w = pflat[path].float()
        assert (g.float() - w).abs().max() <= tol * w.abs().max(), path
