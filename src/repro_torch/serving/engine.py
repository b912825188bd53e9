"""Inference engine: prefill, then greedy decode (counterpart of
``repro/serving/engine.py``: the uniform and ragged ``generate`` paths, the
paged path over an identity-mapped block pool, and the quantized KV cache).

The reference jits ``generate`` into one program per signature, prefill
then a ``lax.scan`` over the decode steps. Here a signature has two
captured programs (``serving/graphs.py``): the prefill, and one decode step
replayed ``max_new_tokens`` times. Sampled tokens, positions (a (b,) device
tensor on every path) and the EOS ``done`` mask live in the programs'
static buffers on the device, so the loop never waits for the card; the
tokens cross to the host once, at the end. ``prefill`` and ``decode_step``
stay the eager one-step APIs. Speculative decode and top-p are not ported
yet.
"""

from __future__ import annotations

import dataclasses
from typing import Mapping

import numpy as np
import torch

from repro_torch.core.policy import quantize_params, quantized_fraction
from repro_torch.core.tree import tree_to
from repro_torch.device import resolve_device
from repro_torch.models.attention import KV_STORE_DTYPES
from repro_torch.models.registry import Model, build
from repro_torch.models.transformer import contiguous_to_paged
from repro_torch.serving.graphs import GraphCache
from repro_torch.serving.sampling import make_sampler


@dataclasses.dataclass
class GenerationResult:
    tokens: torch.Tensor        # (b, max_new_tokens) sampled token ids, on the host
    logits_last: torch.Tensor   # (b, vocab_padded) logits of the last decode step, on the
                                # device (a copy: no later call overwrites it)
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
    on the CPU. ``params`` are moved there. ``graphs`` holds the engine's
    captured programs (``serving/graphs.py``), kept for its lifetime.
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
        self.graphs = GraphCache(self.device)

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
    def _generate_programs(self, b: int, prompt_len: int, ragged: bool, paged: bool,
                           block_size: int, cache_len: int, sampler: str):
        """(prefill, decode step, static state) of one ``generate`` signature.
        The prefill writes the static cache (and, for a quantized paged
        pool, its block layout) in place, samples the first token and sets
        the positions; the decode step reads and advances them in place."""
        model, params, eos, dev = self.model, self.params, self.eos_id, self.device
        sample = make_sampler(sampler)
        key = (b, prompt_len, ragged, paged, block_size, cache_len, sampler, eos)

        def make_state():
            zeros = dict(dtype=torch.long, device=dev)
            st = {"tokens": torch.zeros((b, prompt_len), **zeros),
                  "tok": torch.zeros((b,), **zeros), "pos": torch.zeros((b,), **zeros),
                  "done": torch.zeros((b,), dtype=torch.bool, device=dev),
                  "cache": model.init_cache(b, cache_len, self.cfg.cdtype(), dev)}
            if ragged:
                st["lengths"] = torch.full((b,), prompt_len, **zeros)
            if paged:
                # a float pool is a view of the contiguous cache; a quantized
                # one is laid out anew (kvt-major rows to time-major blocks)
                st["pool"], st["table"] = contiguous_to_paged(st["cache"], block_size)
            return st

        st = self.graphs.state("generate", key, make_state)
        relayout = paged and "k_q" in st["cache"]

        def prefill(tokens, tok, pos, done, cache, lengths=None, pool=None):
            batch = {"tokens": tokens} if lengths is None else {"tokens": tokens,
                                                                 "lengths": lengths}
            logits, _ = model.prefill(params, batch, cache_len, cache=cache)
            first = sample(logits)
            tok.copy_(first)
            if lengths is None:
                pos.fill_(prompt_len)
            else:
                pos.copy_(lengths)
            if eos is not None:
                done.copy_(first == eos)
            if relayout:
                for name, leaf in contiguous_to_paged(cache, block_size)[0].items():
                    pool[name].copy_(leaf)
            return logits

        def decode(tok, pos, done, cache, table=None):
            if paged:
                logits, _ = model.decode_paged(params, tok, cache, table, pos)
            else:
                logits, _ = model.decode(params, tok, cache, pos)
            nxt = sample(logits)
            if eos is not None:
                nxt = torch.where(done, eos, nxt)
                done |= nxt == eos
            tok.copy_(nxt)
            pos.add_(1)
            return logits

        names = ["tokens", "tok", "pos", "done", "cache"]
        names += ["lengths"] * ragged + ["pool"] * relayout
        pre = self.graphs.program("generate.prefill", key, prefill,
                                  lambda: {k: st[k] for k in names})
        dec_in = {"tok": st["tok"], "pos": st["pos"], "done": st["done"],
                  "cache": st["pool"] if paged else st["cache"]}
        if paged:
            dec_in["table"] = st["table"]
        dec = self.graphs.program("generate.decode", key, decode, lambda: dec_in)
        return pre, dec, st

    @torch.inference_mode()
    def generate(self, batch: Mapping, max_new_tokens: int, *, sampler: str = "greedy",
                 lengths=None, paged: bool = False, block_size: int = 8) -> GenerationResult:
        """``lengths`` (b,) enables ragged right-padded prompts: row i's pads
        are masked in prefill, its first token is sampled from the logits at
        lengths[i]-1, and decode runs on per-request position counters.
        ``paged`` decodes through the block-table path over an
        identity-mapped pool of ``block_size``-token blocks, token-identical
        to the contiguous path (the mixed-traffic scheduler is
        serving/paged.py). Runs the signature's captured prefill once and
        its captured decode step ``max_new_tokens`` times."""
        if paged and not self.model.supports_paged:
            raise ValueError(f"{self.cfg.arch_id}: model family has no paged decode path "
                             "(GQA decoder_lm families only)")
        if max_new_tokens < 1:
            raise ValueError(f"max_new_tokens must be >= 1, got {max_new_tokens}")
        make_sampler(sampler)
        tokens = torch.as_tensor(batch["tokens"])
        if lengths is None:
            lengths = batch.get("lengths")
        b, prompt_len = tokens.shape
        # validate up front: an index past the cache would fail mid-decode
        start_max = prompt_len if lengths is None else int(np.max(np.asarray(
            torch.as_tensor(lengths).cpu())))
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
        pre, dec, st = self._generate_programs(b, prompt_len, lengths is not None, paged,
                                               block_size, cache_len, sampler)
        pre.load(tokens=tokens)
        if lengths is not None:
            pre.load(lengths=torch.as_tensor(lengths))
        pre.replay()
        out = torch.empty((b, max_new_tokens), dtype=torch.long, device=self.device)
        out[:, 0] = st["tok"]
        # max_new_tokens decode steps, the last one's token discarded: the
        # reference's scan, whose final logits are logits_last
        for step in range(max_new_tokens):
            dec.replay()
            if step + 1 < max_new_tokens:
                out[:, step + 1] = st["tok"]
        return GenerationResult(tokens=out.cpu(), logits_last=dec.copies(),
                                steps=max_new_tokens)
