"""Inference engine: prefill, then greedy decode (counterpart of
``repro/serving/engine.py``: the uniform and ragged ``generate`` paths, the
paged path over an identity-mapped block pool, and the quantized KV cache).

The reference jits a ``lax.scan`` over decode steps; here the loop runs
eagerly on the device. Sampled tokens, positions and the EOS ``done`` mask
stay on the device throughout, so the loop never waits for the card; the
tokens cross to the host once, at the end. Speculative decode and top-p
are not ported yet.
"""

from __future__ import annotations

import dataclasses
from typing import Mapping

import torch

from repro_torch.core.policy import quantize_params, quantized_fraction
from repro_torch.core.tree import tree_to
from repro_torch.device import resolve_device
from repro_torch.models.attention import KV_STORE_DTYPES
from repro_torch.models.registry import Model, build
from repro_torch.models.transformer import contiguous_to_paged
from repro_torch.serving.sampling import make_sampler


@dataclasses.dataclass
class GenerationResult:
    tokens: torch.Tensor        # (b, max_new_tokens) sampled token ids, on the host
    logits_last: torch.Tensor   # (b, vocab_padded) logits of the last decode step, on the device
    steps: int                  # decode forward passes


class InferenceEngine:
    """Batched generation over a registry ``Model`` on one device.

    ``quantize`` selects the weight formats (``core/policy.py``):

      False / None   float weights
      True           the config's ``quant_format`` ("int8", the paper's W8A8)
      "int8", "int4", "int3", "fp8"
                     one registry format for every quantized leaf
      "mixed"        embeddings and classifier int8, attention/FFN
                     projections packed int4
      "mixed3"       the same with attention/FFN packed int3
      {class: fmt}   an explicit layer-class -> format map
                     (``resolve_format_map``; a class mapped to None stays
                     float)

    ``kv_quant`` ("int8" or "fp8") stores the KV cache,
    contiguous or paged, at storage width with per-row f32 scales,
    dequantized inside attention; GQA decoder_lm families only. ``device``
    defaults to "cuda" and raises when CUDA is missing; pass "cpu" to run
    on the CPU. ``params`` are moved there.
    """

    def __init__(self, model: Model, params, *, cache_len: int,
                 quantize: bool | str | Mapping[str, str | None] = False,
                 eos_id: int | None = None,
                 kv_quant: str | None = None, device: str | torch.device = "cuda"):
        self.device = resolve_device(device)
        if kv_quant:
            if kv_quant not in KV_STORE_DTYPES:
                raise ValueError(f"unknown kv_quant format {kv_quant!r}; supported: "
                                 f"{sorted(KV_STORE_DTYPES)}")
            if not model.supports_paged:
                # supports_paged == "GQA decoder_lm cache layouts", the
                # families whose KV rows the quantized layout covers
                raise ValueError(f"{model.cfg.arch_id}: kv_quant covers the GQA "
                                 "decoder_lm cache layouts only")
            if model.cfg.kv_quant != kv_quant:
                # rebuild so every model closure sees the threaded config
                model = build(dataclasses.replace(model.cfg, kv_quant=kv_quant))
        self.model = model
        self.cfg = model.cfg
        self.cache_len = cache_len
        self.eos_id = eos_id
        params = tree_to(params, self.device)
        if quantize is not False and quantize is not None:
            formats = self.cfg.quant_format if quantize is True else quantize
            params = quantize_params(params, self.cfg.group_size, formats=formats)
        self.params = params
        self.quantized_fraction = quantized_fraction(params)

    def _device_batch(self, batch: Mapping) -> dict:
        out = {"tokens": torch.as_tensor(batch["tokens"]).to(self.device, torch.long)}
        if batch.get("lengths") is not None:
            out["lengths"] = torch.as_tensor(batch["lengths"]).to(self.device, torch.long)
        return out

    # -- one-step APIs ---------------------------------------------------------
    @torch.inference_mode()
    def prefill(self, batch: Mapping):
        return self.model.prefill(self.params, self._device_batch(batch), self.cache_len)

    @torch.inference_mode()
    def decode_step(self, token, cache, pos):
        """pos: int or (b,) per-request position tensor."""
        return self.model.decode(self.params, token, cache, pos)

    # -- full generation -------------------------------------------------------
    @torch.inference_mode()
    def generate(self, batch: Mapping, max_new_tokens: int, *, sampler: str = "greedy",
                 lengths=None, paged: bool = False, block_size: int = 8) -> GenerationResult:
        """``lengths`` (b,) enables ragged right-padded prompts: row i's pads
        are masked in prefill, its first token is sampled from the logits at
        lengths[i]-1, and decode runs on per-request position counters.
        ``paged`` decodes through the block-table path over an
        identity-mapped pool of ``block_size``-token blocks, token-identical
        to the contiguous path (the mixed-traffic scheduler is
        serving/paged.py)."""
        if paged and not self.model.supports_paged:
            raise ValueError(f"{self.cfg.arch_id}: model family has no paged decode path "
                             "(GQA decoder_lm families only)")
        if max_new_tokens < 1:
            raise ValueError(f"max_new_tokens must be >= 1, got {max_new_tokens}")
        sample = make_sampler(sampler)
        if lengths is not None:
            batch = dict(batch, lengths=lengths)
        batch = self._device_batch(batch)
        b, prompt_len = batch["tokens"].shape
        lengths = batch.get("lengths")
        # validate up front: an index past the cache would fail mid-decode
        start_max = prompt_len if lengths is None else int(lengths.max())
        need = max(prompt_len, start_max + max_new_tokens)
        if need > self.cache_len:
            raise ValueError(
                f"KV cache overflow: prompt_len={prompt_len} (max start {start_max}) "
                f"+ max_new_tokens={max_new_tokens} needs {need} slots but "
                f"cache_len={self.cache_len}")

        cache_len = self.cache_len
        if paged:
            # pad the prefill target up to whole blocks so the contiguous
            # rows reshape exactly into the pool
            cache_len = -(-cache_len // block_size) * block_size
        logits, cache = self.model.prefill(self.params, batch, cache_len)
        tok = sample(logits)
        # ragged rows continue at their own lengths (per-row cache commits);
        # a uniform batch keeps one host-side position counter
        pos = lengths.clone() if lengths is not None else prompt_len
        if paged:
            cache, table = contiguous_to_paged(cache, block_size)
            if lengths is None:
                pos = torch.full((b,), prompt_len, dtype=torch.long, device=self.device)
        eos = self.eos_id
        done = tok == eos if eos is not None else None
        out = torch.empty((b, max_new_tokens), dtype=torch.long, device=self.device)
        out[:, 0] = tok
        # max_new_tokens decode steps, the last one's token discarded: the
        # reference's scan, whose final logits are logits_last
        for step in range(max_new_tokens):
            if paged:
                logits, cache = self.model.decode_paged(self.params, tok, cache, table, pos)
            else:
                logits, cache = self.model.decode(self.params, tok, cache, pos)
            nxt = sample(logits)
            if eos is not None:
                nxt = torch.where(done, eos, nxt)
                done = done | (nxt == eos)
            if step + 1 < max_new_tokens:
                out[:, step + 1] = nxt
            tok = nxt
            pos = pos + 1
        return GenerationResult(tokens=out.cpu(), logits_last=logits, steps=max_new_tokens)
