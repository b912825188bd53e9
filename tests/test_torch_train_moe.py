"""Loss and every gradient leaf of one train step against the reference's
for the MoE and MLA families (dbrx-132b, minicpm3-4b, deepseek-v2-lite-16b)
and the encoder-decoder (seamless-m4t-large-v2: its non-causal encoder
under ``blockwise_attention`` runs the plain flash backward with
``causal=False``), reduced configs, f32, with and without the flag, within
``tests/_torch_train.py``'s tolerances. On these inputs every router top-k
choice equals the reference's (no near tie within
``_torch_families.ROUTER_TIE``: a flipped choice would move the expert
leaves' gradients far past the tolerance)."""

import pytest

torch = pytest.importorskip("torch")

from _torch_train import assert_grads_close, both_grads  # noqa: E402

ARCHS = ("dbrx-132b", "minicpm3-4b", "deepseek-v2-lite-16b", "seamless-m4t-large-v2")


@pytest.mark.parametrize("blockwise", [False, True])
@pytest.mark.parametrize("arch", ARCHS)
def test_family_loss_and_gradients_equal_reference(arch, blockwise):
    assert_grads_close(*both_grads(arch, blockwise=blockwise))
