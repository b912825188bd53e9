"""Perf-variant feature flags (counterpart of ``repro/core/flags.py``).

The same switches, keys and defaults as the reference, so one
``overrides(...)`` names the same variant in both packages. The two
packages keep separate globals: a comparison enters both.

  deferred_decode_cache  decode layers return only their new K/V rows, which
                         are committed once after the last layer
  blockwise_attention    chunked online-softmax attention (flash-style) for
                         the scoring forward and prefill: the CUDA kernel
                         ``csrc/flash_attn.cu`` on the card
                         (``kernels/ops.flash_attention``)
  attention_chunk        the plain version's K/V chunk (cut to a divisor of
                         the key length)
  kvt_cache_layout       contiguous KV cache stored (L, b, KV, T, hd); implies
                         the deferred decode
  int8_kv_cache          the KV cache quantized to int8 per (position, head)
                         row, the reference's older switch for
                         ``cfg.kv_quant="int8"``; implies the kvt layout
  prefill_dequant        every quantized ``linear`` dequantizes its weight
                         and runs a float product instead of GQMM while set
  chunked_ssd, ssd_chunk Mamba2's chunked scan; kept so the two dicts match
                         key for key (no SSM family is ported, nothing reads
                         them)
"""

from __future__ import annotations

import contextlib

FLAGS: dict[str, bool | int] = {
    "deferred_decode_cache": False,
    "blockwise_attention": False,
    "attention_chunk": 1024,
    "kvt_cache_layout": False,
    "int8_kv_cache": False,
    "prefill_dequant": False,
    "chunked_ssd": False,
    "ssd_chunk": 128,
}


def get(name: str):
    return FLAGS[name]


@contextlib.contextmanager
def overrides(**kw):
    old = {k: FLAGS[k] for k in kw}
    FLAGS.update(kw)
    try:
        yield
    finally:
        FLAGS.update(old)
