"""Port configs and registry against the reference, field for field."""

import dataclasses

import pytest

torch = pytest.importorskip("torch")

from repro.configs.base import ModelConfig as JModelConfig  # noqa: E402
from repro.models import registry as jreg  # noqa: E402
from repro_torch.configs.base import ModelConfig, MoEConfig  # noqa: E402
from repro_torch.models import registry  # noqa: E402


@pytest.mark.parametrize("reduced", [False, True])
def test_tinyllama_config_equals_reference(reduced):
    ref = jreg.load_config("tinyllama-1.1b")
    cfg = registry.load_config("tinyllama-1.1b")
    if reduced:
        ref, cfg = ref.reduced(), cfg.reduced()
    assert dataclasses.asdict(cfg) == dataclasses.asdict(ref)
    for prop in ("vocab_padded", "resolved_head_dim", "q_dim", "kv_dim"):
        assert getattr(cfg, prop) == getattr(ref, prop), prop


@pytest.mark.parametrize("reduced", [False, True])
@pytest.mark.parametrize("arch", ["dbrx-132b", "deepseek-v2-lite-16b", "minicpm3-4b"])
def test_moe_mla_configs_equal_reference(arch, reduced):
    """The MoE and MLA configs field for field, their MoEConfig / MLAConfig
    and reduced() cut included."""
    ref, cfg = jreg.load_config(arch), registry.load_config(arch)
    if reduced:
        ref, cfg = ref.reduced(), cfg.reduced()
    assert dataclasses.asdict(cfg) == dataclasses.asdict(ref)
    assert (cfg.moe is None) == (ref.moe is None) and (cfg.mla is None) == (ref.mla is None)
    for prop in ("vocab_padded", "resolved_head_dim", "q_dim", "kv_dim"):
        assert getattr(cfg, prop) == getattr(ref, prop), prop


@pytest.mark.parametrize("reduced", [False, True])
@pytest.mark.parametrize("arch", ["rwkv6-7b", "zamba2-7b"])
def test_recurrent_configs_equal_reference(arch, reduced):
    """The recurrent configs field for field, their SSMConfig, shared-block
    period and reduced() cut included."""
    ref, cfg = jreg.load_config(arch), registry.load_config(arch)
    if reduced:
        ref, cfg = ref.reduced(), cfg.reduced()
    assert dataclasses.asdict(cfg) == dataclasses.asdict(ref)
    assert (cfg.ssm is None) == (ref.ssm is None)
    for prop in ("vocab_padded", "resolved_head_dim", "q_dim", "kv_dim"):
        assert getattr(cfg, prop) == getattr(ref, prop), prop


def test_dataclass_fields_and_defaults_match_reference():
    mine = {f.name: f.default for f in dataclasses.fields(ModelConfig)}
    ref = {f.name: f.default for f in dataclasses.fields(JModelConfig)}
    assert mine == ref


def test_dtypes_are_torch_dtypes():
    cfg = registry.load_config("tinyllama-1.1b")
    assert cfg.pdtype() is torch.bfloat16 and cfg.cdtype() is torch.bfloat16
    red = cfg.reduced()
    assert red.pdtype() is torch.float32 and red.cdtype() is torch.float32


def test_arch_ids_match_reference():
    assert registry.ARCH_IDS == jreg.ARCH_IDS


@pytest.mark.parametrize("reduced", [False, True])
def test_seamless_config_equals_reference(reduced):
    """The encoder-decoder, the last config to port: field for field, its
    encoder depth and frames frontend included; every config is ported."""
    ref, cfg = jreg.load_config("seamless-m4t-large-v2"), registry.load_config(
        "seamless-m4t-large-v2")
    if reduced:
        ref, cfg = ref.reduced(), cfg.reduced()
    assert dataclasses.asdict(cfg) == dataclasses.asdict(ref)
    for prop in ("vocab_padded", "resolved_head_dim", "q_dim", "kv_dim"):
        assert getattr(cfg, prop) == getattr(ref, prop), prop
    assert (cfg.encoder_layers, cfg.frontend) == ((2, "frames") if reduced else (24, "frames"))
    assert set(registry.PORTED_ARCHS) == set(jreg.ARCH_IDS)


def test_unknown_arch_raises():
    with pytest.raises(ValueError, match="unknown arch"):
        registry.load_config("llama-9000")


def test_model_declares_capabilities():
    model = registry.build(registry.load_config("tinyllama-1.1b").reduced())
    jmodel = jreg.build(jreg.load_config("tinyllama-1.1b").reduced())
    assert model.supports_lengths is jmodel.supports_lengths is True
    assert model.supports_paged is jmodel.supports_paged is True
    assert model.cache_kind == jmodel.cache_kind == "kv"
    for hook in ("init_paged_cache", "decode_paged", "insert_slots", "gather_slots",
                 "verify", "commit_verify", "verify_paged", "commit_verify_paged"):
        assert callable(getattr(model, hook)), hook
    # speculative verify is ported: declared as in the reference
    assert model.supports_spec is jmodel.supports_spec is True


def test_build_refuses_unported_features():
    # a decoder LM takes no frontend but pixtral's patch embeddings (seamless's
    # speech frames belong to the encoder-decoder); MoE, MLA and gemma2's window,
    # caps and norms are ported
    cfg = dataclasses.replace(registry.load_config("tinyllama-1.1b").reduced(),
                              frontend="frames")
    with pytest.raises(NotImplementedError, match="not ported"):
        registry.build(cfg)
    moe = dataclasses.replace(registry.load_config("tinyllama-1.1b").reduced(),
                              moe=MoEConfig(num_experts=4, top_k=2, d_expert=64))
    assert registry.build(moe).supports_spec
