"""Loss and every gradient leaf of one train step for each trainable
family against the reference's ``jax.value_and_grad(make_loss_fn(model))``
on the reduced configs, the same f32 weights and batch, with and without
``blockwise_attention`` (the port's plain flash backward against XLA's
gradient of ``_mha_blockwise``): each leaf within 1e-5 of the reference
leaf's max|g|, the loss within 1e-6 relative (``tests/_torch_train.py``).
The MoE families' router top-k choices equal the reference's on these
inputs (a flipped choice would move a gradient leaf far past the
tolerance)."""

import pytest

torch = pytest.importorskip("torch")

from _torch_train import assert_grads_close, both_grads  # noqa: E402

DENSE = ("internlm2-1.8b", "deepseek-coder-33b", "pixtral-12b", "gemma2-2b")


@pytest.mark.parametrize("blockwise", [False, True])
@pytest.mark.parametrize("arch", DENSE)
def test_dense_family_loss_and_gradients_equal_reference(arch, blockwise):
    assert_grads_close(*both_grads(arch, blockwise=blockwise))


@pytest.mark.parametrize("blockwise", [False, True])
def test_gemma2_window_and_caps_reach_the_gradient(blockwise):
    """gemma2's window cut to 8 of a 16-token batch in both packages, its
    norms perturbed: the local layers' masks, the soft caps and the plus-one
    norms all act on the gradient."""
    assert_grads_close(*both_grads("gemma2-2b", blockwise=blockwise,
                                   overrides={"sliding_window": 8}, norm_scale=0.1))
