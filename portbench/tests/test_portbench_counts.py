"""portbench/counts.py by hand and against the port's kernels/bounds.py."""

from __future__ import annotations

import dataclasses

import pytest

from portbench import counts
from portbench.tests._tiny import config

INTERNLM2 = config("internlm2-1.8b-w8a8")
DSV2 = config("deepseek-v2-lite-16b-w8a8")
Q8 = {"format": "int8", "group_size": 256}
Q8_128 = {"format": "int8", "group_size": 128}


def test_one_projection_by_hand():
    # internlm2's wo at one row, group size 256: weights, f32 scales, int8
    # activations and their scales, f32 outputs
    w = counts.projection(2048, 2048, 1, 256)
    assert w.nbytes == 2048 * 2048 + 4 * 2048 * 2048 // 256 + 2048 + 4 * 2048 // 256 + 4 * 2048
    assert w.nbytes == 4_270_112
    assert w.int8_ops == 8_388_608 and w.bf16_ops == 0


def test_internlm2_decode_step_by_hand():
    shape = INTERNLM2["port"]
    ctx = 300
    w = counts.decode(shape, Q8, 1, [ctx])
    weights = 24 * (2048 * 30720 + 4 * 2048 * 30720 // 256) + 92544 * 2048 + 4 * 92544 * 2048 // 256
    assert weights == 1_726_033_920
    acts = 24 * (18464 + 10272 + 67616 + 16512) + (2048 + 32 + 4 * 92544)
    assert acts == 3_080_992
    kv = 24 * (ctx + 1) * 2 * 8 * 128 * 2
    assert w.nbytes == weights + acts + kv
    assert w.int8_ops == 2 * (30720 * 2048 * 24 + 92544 * 2048) == 3_398_959_104
    assert w.bf16_ops == 24 * 4 * 16 * 128 * ctx
    assert w.seconds == pytest.approx(w.nbytes / 3.35e12)


def test_dsv2lite_layer_by_hand():
    shape = dict(DSV2["port"], num_layers=1)
    names = [(n, m, k, kind) for n, m, k, kind in counts.layer_projections(shape)]
    assert names == [("wq", 3072, 2048, "dense"), ("wdkv", 576, 2048, "dense"),
                     ("wukv", 4096, 512, "dense"), ("wo", 2048, 2048, "dense"),
                     ("expert w13", 2816, 2048, "routed"), ("expert w2", 2048, 1408, "routed"),
                     ("shared w13", 5632, 2048, "dense"), ("shared w2", 2048, 2816, "dense")]
    dense = 3072 * 2048 + 576 * 2048 + 4096 * 512 + 2048 * 2048 + 5632 * 2048 + 2048 * 2816
    routed = 6 * (2816 * 2048 + 2048 * 1408)          # top-6 a layer, the fewest distinct
    layer = (dense + routed) * (1 + 4 / 128)
    classifier = 102400 * 2048 * (1 + 4 / 128)
    assert layer == 85_561_344
    assert counts.projections(shape, Q8_128, 0).nbytes == layer + classifier
    # operations a token: every dense matrix, 6 routed experts, the classifier
    one = counts.projections(shape, Q8_128, 1)
    assert one.int8_ops == 2 * (dense + routed + 102400 * 2048)
    # a decode step applies wukv absorbed: not a GQMM projection
    gq = counts.projections(shape, Q8_128, 1, gqmm_only=True, decode=True)
    assert one.int8_ops - gq.int8_ops == 2 * 4096 * 512


def test_prefill_counts_true_lengths_and_causal_pairs():
    shape = INTERNLM2["port"]
    w = counts.prefill(shape, Q8, [100, 28])
    p = counts.projections(shape, Q8, 128)
    pairs = 100 * 101 // 2 + 28 * 29 // 2
    assert w.int8_ops == p.int8_ops
    assert w.bf16_ops == 24 * 4 * 16 * 128 * pairs
    assert w.nbytes == p.nbytes + 24 * 128 * 2 * 8 * 128 * 2
    assert counts.request_contexts(10, 4) == [11, 12, 13]


def _port_cfg(shape):
    from portbench.drive import model_config

    return model_config(shape)


@pytest.mark.parametrize("b", [1, 4, 32, 256])
def test_against_bounds_dense(b):
    from repro_torch.kernels import bounds

    shape = INTERNLM2["port"]
    cfg = _port_cfg(shape)
    ours = counts.projections(shape, Q8, b)
    theirs = bounds.projection_pass(cfg, "int8", b)
    assert (ours.nbytes, ours.int8_ops) == (theirs.nbytes, theirs.ops)
    for m, n, _ in bounds.projections(cfg):
        gs = bounds.group_size(cfg, n)
        assert counts.group_size(n, 256) == gs
        one = bounds.projection("int8", m, n, b, gs)
        assert counts.projection(m, n, b, gs).nbytes == one.nbytes
    assert counts.HBM_BYTES_PER_S == bounds.HBM_BYTES_PER_S
    assert counts.PEAK_OPS_PER_S["int8"] == bounds.PEAK_OPS_PER_S["int8"]
    assert counts.PEAK_OPS_PER_S["bf16"] == bounds.PEAK_OPS_PER_S["bf16"]


@pytest.mark.parametrize("b", [1, 32])
def test_against_bounds_moe_every_expert(b):
    """bounds counts every expert (the dense dispatch reads them all); with
    top_k = num_experts the two agree."""
    from repro_torch.kernels import bounds

    shape = dict(DSV2["port"])
    shape["moe"] = dataclasses.asdict(_port_cfg(shape).moe) | {"top_k": 64}
    cfg = _port_cfg(DSV2["port"])
    ours = counts.projections(shape, Q8_128, b)
    theirs = bounds.projection_pass(cfg, "int8", b)
    assert (ours.nbytes, ours.int8_ops) == (theirs.nbytes, theirs.ops)
