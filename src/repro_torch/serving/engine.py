"""Inference engine: prefill, then greedy or top-p decode, vanilla or
speculative (counterpart of ``repro/serving/engine.py``: the uniform and
ragged ``generate`` paths, the paged path over an identity-mapped block
pool, the quantized KV cache and ``_generate_spec``).

The reference jits ``generate`` into one program per signature, prefill
then a ``lax.scan`` over the decode steps. Here a signature has two
captured programs (``serving/graphs.py``): the prefill, and one decode step
replayed ``max_new_tokens`` times. Sampled tokens, positions (a (b,) device
tensor on every path) and the EOS ``done`` mask live in the programs'
static buffers on the device, so the loop never waits for the card; the
tokens cross to the host once, at the end. ``prefill`` and ``decode_step``
stay the eager one-step APIs. Top-p draws its noise from a generator on the
device into a static buffer before each replay (``serving/sampling.py``).
Speculative decode (``spec_k``) replays the prefill, then one captured
verify program a step (``serving/spec.py``), drafting on the host.

The recurrent families (``cache_kind="state"``: rwkv6, zamba2) take the
same programs: the static cache is their recurrent state, which prefill
writes and each decode step advances in place. They refuse ragged
``lengths`` (a recurrent prefill cannot skip pad tokens), and a family
whose state does not grow with ``cache_len`` (``unbounded_state``) skips
the overflow check.

The encoder-decoder (``cache_kind="none"``) takes ``batch["frames"]``, its
encoder's input, into a static buffer of the signature beside the prompt;
its static cache holds exactly as many cross K/V rows as the frames have
positions (cross attention attends to every memory row).

``sanitize`` (None: the ``REPRO_SAN`` environment decides) arms repro-san
(analysis/sanitizer.py): the quantize/dequantize tripwires before the
weights are quantized, every scheduler over the engine, and a check of
``generate``'s last logits. ``snapshot``/``restore`` carry generation state
(with the block table on the paged path) to the host and back.
"""

from __future__ import annotations

import dataclasses
from typing import Mapping

import numpy as np
import torch

from repro_torch.analysis.sanitizer import check_array, sanitize_enabled
from repro_torch.core.policy import quantize_params, quantized_fraction
from repro_torch.core.quant import set_numerics_checks
from repro_torch.core.tree import tree_leaves, tree_map, tree_to
from repro_torch.device import resolve_device
from repro_torch.models.attention import KV_STORE_DTYPES
from repro_torch.models.registry import Model, build
from repro_torch.models.transformer import contiguous_to_paged
from repro_torch.serving.graphs import GraphCache
from repro_torch.serving.core import verify_inputs
from repro_torch.serving.sampling import GUMBEL, draw_noise, make_sampler, needs_noise, sampler_sig
from repro_torch.serving.spec import NgramDrafter, build_verify_step, draft_chunk, take_accepted

# a batch's model inputs beside the tokens: pixtral's patch embeddings, the
# encoder-decoder's frames
EXTRA_INPUTS = ("patch_embeds", "frames")


@dataclasses.dataclass
class GenerationResult:
    tokens: torch.Tensor        # (b, max_new_tokens) sampled token ids, on the host
    # (b, vocab_padded) logits on the device (a copy: no later call overwrites
    # it). The two paths differ, as in the reference: vanilla decode returns
    # the distribution after the last returned token (the discarded step's),
    # the speculative path the one that produced each row's final kept token
    # (one row later when an EOS cut its chunk). Don't compare across paths.
    logits_last: torch.Tensor
    steps: int                  # decode forward passes (speculative: verify steps)
    # speculative accounting (None on the vanilla path): verify forward
    # passes, tokens delivered (each row's prefill token included; tokens
    # past an EOS or the budget excluded), drafts proposed and accepted
    spec_stats: dict[str, int] | None = None


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
    ``sanitize`` arms repro-san; None defers to ``REPRO_SAN``.
    """

    def __init__(self, model: Model, params, *, cache_len: int,
                 quantize: bool | str | Mapping[str, str | None] = False,
                 eos_id: int | None = None, sanitize: bool | None = None,
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
                                 "decoder_lm cache layouts only (no MLA/recurrent/encdec)")
            if model.cfg.kv_quant != kv_quant:
                # rebuild so every model closure sees the threaded config
                model = build(dataclasses.replace(model.cfg, kv_quant=kv_quant))
        self.model = model
        self.cfg = model.cfg
        self.cache_len = cache_len
        self.eos_id = eos_id
        # schedulers built on this engine take the resolved setting; the
        # numerics checks arm before quantization, so a corrupt checkpoint
        # fails at init with its param path and layer class
        self.sanitize = bool(sanitize_enabled() if sanitize is None else sanitize)
        if self.sanitize:
            set_numerics_checks(True)
        params = tree_to(params, self.device)
        if quantize is not False and quantize is not None:
            formats = self.cfg.quant_format if quantize is True else quantize
            params = quantize_params(params, self.cfg.group_size, formats=formats)
        self.params = params
        self.quantized_fraction = quantized_fraction(params)
        self.graphs = GraphCache(self.device, self.cfg)
        # True for a cache_kind="state" family whose decode state is O(1) in
        # cache_len (rwkv6; zamba2's shared KV rows grow with it): nothing to
        # overflow, so the generate and serve length checks are skipped.
        # Probed on the meta device, as the reference probes with eval_shape.
        self.unbounded_state = model.cache_kind == "state" and all(
            x.shape == y.shape for x, y in zip(*(
                tree_leaves(model.init_cache(1, t, self.cfg.cdtype(), "meta")) for t in (8, 16))))

    def _device_batch(self, batch: Mapping) -> dict:
        out = {"tokens": torch.as_tensor(batch["tokens"]).to(self.device, torch.long)}
        if batch.get("lengths") is not None:
            out["lengths"] = torch.as_tensor(batch["lengths"]).to(self.device, torch.long)
        for name in EXTRA_INPUTS:
            if batch.get(name) is not None:
                out[name] = torch.as_tensor(batch[name]).to(self.device)
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
    def _generate_state(self, b: int, prompt_len: int, ragged: bool, paged: bool,
                        block_size: int, cache_len: int, sampler: tuple,
                        extra: dict[str, torch.Tensor]) -> tuple[tuple, dict]:
        """(key, static buffers) of one ``generate`` signature: the prompt,
        token, position, EOS flag, cache (and pool and table), for a
        sampler that draws noise its Gumbel buffer (b, V), and for each of
        the batch's ``extra`` inputs (pixtral's ``patch_embeds``, the
        encoder-decoder's ``frames``) a buffer of its shape and type. With
        ``frames`` (b, s_enc, d) the cache's cross K/V get s_enc rows."""
        dev = self.device
        shapes = tuple((name, tuple(t.shape), t.dtype) for name, t in sorted(extra.items()))
        key = (b, prompt_len, ragged, paged, block_size, cache_len, sampler, self.eos_id, shapes)

        def make_state():
            zeros = dict(dtype=torch.long, device=dev)
            mem = {"memory_len": extra["frames"].shape[1]} if "frames" in extra else {}
            st = {"tokens": torch.zeros((b, prompt_len), **zeros),
                  "tok": torch.zeros((b,), **zeros), "pos": torch.zeros((b,), **zeros),
                  "done": torch.zeros((b,), dtype=torch.bool, device=dev),
                  "cache": self.model.init_cache(b, cache_len, self.cfg.cdtype(), dev, **mem)}
            if ragged:
                st["lengths"] = torch.full((b,), prompt_len, **zeros)
            for name, shape, dtype in shapes:
                st[name] = torch.zeros(shape, dtype=dtype, device=dev)
            if paged:
                # a float pool is a view of the contiguous cache; a quantized
                # one is laid out anew (kvt-major rows to time-major blocks)
                st["pool"], st["table"] = contiguous_to_paged(st["cache"], block_size)
            if needs_noise(sampler[0]):
                st[GUMBEL] = torch.zeros((b, self.cfg.vocab_padded), dtype=torch.float32,
                                         device=dev)
            return st

        return key, self.graphs.state("generate", key, make_state)

    def _prefill_program(self, key: tuple, st: dict, prompt_len: int, cache_len: int,
                         block_size: int, sample):
        """The signature's prefill: writes the static cache (and, for a
        quantized paged pool, its block layout) in place, samples the first
        token and sets the positions; returns the logits."""
        model, params, eos = self.model, self.params, self.eos_id
        relayout = "pool" in st and "k_q" in st["cache"]

        def prefill(tokens, tok, pos, done, cache, lengths=None, pool=None, gumbel=None,
                    patch_embeds=None, frames=None):
            batch = {"tokens": tokens, "lengths": lengths, "patch_embeds": patch_embeds,
                     "frames": frames}
            logits, _ = model.prefill(params, batch, cache_len, cache=cache)
            first = sample(logits, gumbel=gumbel)
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

        names = ["tokens", "tok", "pos", "done", "cache"]
        names += [n for n in ("lengths", GUMBEL, *EXTRA_INPUTS) if n in st]
        names += ["pool"] * relayout
        return self.graphs.program("generate.prefill", key, prefill,
                                   lambda: {k: st[k] for k in names})

    def _decode_program(self, key: tuple, st: dict, sample):
        """The signature's decode step: reads and advances token, position
        and EOS flag in place; returns the logits."""
        model, params, eos = self.model, self.params, self.eos_id
        paged = "pool" in st

        def decode(tok, pos, done, cache, table=None, gumbel=None):
            if paged:
                logits, _ = model.decode_paged(params, tok, cache, table, pos)
            else:
                logits, _ = model.decode(params, tok, cache, pos)
            nxt = sample(logits, gumbel=gumbel)
            if eos is not None:
                nxt = torch.where(done, eos, nxt)
                done |= nxt == eos
            tok.copy_(nxt)
            pos.add_(1)
            return logits

        dec_in = {"tok": st["tok"], "pos": st["pos"], "done": st["done"],
                  "cache": st["pool"] if paged else st["cache"]}
        if paged:
            dec_in["table"] = st["table"]
        if GUMBEL in st:
            dec_in[GUMBEL] = st[GUMBEL]
        return self.graphs.program("generate.decode", key, decode, lambda: dec_in)

    def _verify_program(self, key: tuple, st: dict, spec_k: int, sampler: tuple,
                        logits0: torch.Tensor):
        """The speculative verify step over the signature's cache (or pool
        and table) and positions (``spec.build_verify_step``): the chunk,
        ``live`` and ``remaining`` are its own buffers, top-p's noise too,
        and ``last`` keeps each row's logits of its newest kept token."""
        paged = "pool" in st
        step = build_verify_step(self.model, self.params, sampler=sampler[0],
                                 sampler_kw=dict(sampler[1]), paged=paged)
        shared = {k: st[k] for k in ("pos", "table", GUMBEL) if k in st}
        return self.graphs.program(
            "generate.verify", key + (spec_k,), step, lambda: verify_inputs(
                self, st["tok"].shape[0], spec_k, sampler[0],
                st["pool"] if paged else st["cache"], last=torch.zeros_like(logits0), **shared))

    @torch.inference_mode()
    def generate(self, batch: Mapping, max_new_tokens: int, *, sampler: str = "greedy",
                 sampler_kw=None, seed: int = 0, lengths=None, paged: bool = False,
                 block_size: int = 8, spec_k: int | None = None,
                 drafter=None) -> GenerationResult:
        """``lengths`` (b,) enables ragged right-padded prompts: row i's pads
        are masked in prefill, its first token is sampled from the logits at
        lengths[i]-1, and decode runs on per-request position counters.
        ``sampler_kw`` reaches the sampler (top_p's p / temperature); a
        sampler that draws noise draws it from a generator on the engine's
        device seeded with ``seed``. ``paged`` decodes through the
        block-table path over an identity-mapped pool of ``block_size``-token
        blocks, token-identical to the contiguous path (the mixed-traffic
        scheduler is serving/paged.py). Runs the signature's captured
        prefill once and its captured decode step ``max_new_tokens`` times.

        ``spec_k`` >= 2 decodes in speculative chunks: each step verifies the
        current token plus ``spec_k - 1`` drafted candidates in one forward
        pass (serving/spec.py), producing 1..spec_k tokens a weight stream;
        ``drafter`` defaults to the n-gram prompt-lookup drafter. Greedy
        speculative output equals vanilla decode's."""
        if paged and not self.model.supports_paged:
            raise ValueError(f"{self.cfg.arch_id}: model family has no paged decode path "
                             "(GQA decoder_lm families only)")
        if max_new_tokens < 1:
            raise ValueError(f"max_new_tokens must be >= 1, got {max_new_tokens}")
        sample = make_sampler(sampler, **dict(sampler_kw or {}))
        tokens = torch.as_tensor(batch["tokens"])
        if lengths is None:
            lengths = batch.get("lengths")
        if lengths is not None and not self.model.supports_lengths:
            raise ValueError(f"{self.cfg.arch_id}: model family does not support ragged "
                             "lengths; batch by exact length instead (see serving/batching.py)")
        b, prompt_len = tokens.shape
        # validate up front: an index past the cache would fail mid-decode; a
        # verify chunk reads and writes columns up to pos + spec_k - 1, so the
        # speculative path needs spec_k slots of slack past the vanilla need
        start_max = prompt_len if lengths is None else int(np.max(np.asarray(
            torch.as_tensor(lengths).cpu())))
        need = max(prompt_len, start_max + max_new_tokens + (spec_k or 0))
        # a family with O(1) state (rwkv6) has no cache axis to overflow
        if need > self.cache_len and not self.unbounded_state:
            raise ValueError(
                f"KV cache overflow: prompt_len={prompt_len} (max start {start_max}) "
                f"+ max_new_tokens={max_new_tokens}"
                + (f" + spec_k={spec_k}" if spec_k else "")
                + f" needs {need} slots but cache_len={self.cache_len}")
        if spec_k is not None:
            if spec_k < 2:
                raise ValueError(f"spec_k must be >= 2 (got {spec_k}): a chunk is the "
                                 "current token plus >=1 draft")
            if self.cfg.kv_quant:
                raise ValueError(
                    f"{self.cfg.arch_id}: speculative decode requires the float KV layout "
                    "(kv_quant off): the verify chunk scatters float rows the quantized "
                    "cache cannot hold")
            if not self.model.supports_spec:
                raise ValueError(f"{self.cfg.arch_id}: model family has no speculative "
                                 "verify path (GQA decoder_lm families only)")

        cache_len = self.cache_len
        if paged:
            # pad the prefill target up to whole blocks so the contiguous
            # rows reshape exactly into the pool
            cache_len = -(-cache_len // block_size) * block_size
        sig = (sampler, sampler_sig(sampler_kw))
        extra = {name: torch.as_tensor(batch[name]) for name in EXTRA_INPUTS
                 if batch.get(name) is not None}
        key, st = self._generate_state(b, prompt_len, lengths is not None, paged, block_size,
                                       cache_len, sig, extra)
        pre = self._prefill_program(key, st, prompt_len, cache_len, block_size, sample)
        gen = torch.Generator(device=self.device).manual_seed(seed)
        pre.load(tokens=tokens, **extra)
        if lengths is not None:
            pre.load(lengths=torch.as_tensor(lengths))
        draw_noise(pre.inputs, gen)
        logits0 = pre.replay()
        if spec_k is not None:
            return self._generate_spec(key, st, tokens, lengths, logits0, max_new_tokens,
                                       spec_k, drafter, sig, gen)
        dec = self._decode_program(key, st, sample)
        out = torch.empty((b, max_new_tokens), dtype=torch.long, device=self.device)
        out[:, 0] = st["tok"]
        # max_new_tokens decode steps, the last one's token discarded: the
        # reference's scan, whose final logits are logits_last
        for step in range(max_new_tokens):
            draw_noise(dec.inputs, gen)
            dec.replay()
            if step + 1 < max_new_tokens:
                out[:, step + 1] = st["tok"]
        logits = dec.copies()
        if self.sanitize:
            check_array("generate.logits_last", logits)
        return GenerationResult(tokens=out.cpu(), logits_last=logits, steps=max_new_tokens)

    def _generate_spec(self, key, st, tokens, lengths, logits0, max_new: int, spec_k: int,
                       drafter, sampler: tuple, gen) -> GenerationResult:
        """Host-driven speculative generation after the signature's prefill:
        draft on the host (the n-gram drafter needs the token history), then
        one replay of the verify program a step, which accepts, commits and
        advances the positions on the device, and one transfer a step (the
        step's tokens and counts). Rows advance unevenly: positions are the
        per-row device tensor throughout."""
        drafter = drafter if drafter is not None else NgramDrafter()
        eos = self.eos_id
        toks_np = tokens.cpu().numpy()
        b, prompt_len = toks_np.shape
        lens = (np.asarray(torch.as_tensor(lengths).cpu(), np.int64) if lengths is not None
                else np.full((b,), prompt_len, np.int64))
        ver = self._verify_program(key, st, spec_k, sampler, logits0)
        # seeded with the prefill logits: a row that finishes before its
        # first verify step still reports the distribution of its token
        ver.inputs["last"].copy_(logits0)
        tok0 = st["tok"].cpu().numpy()
        ctx = [[int(t) for t in toks_np[i, : lens[i]]] + [int(tok0[i])] for i in range(b)]
        outs = [[int(tok0[i])] for i in range(b)]
        done = np.asarray([eos is not None and int(t) == eos for t in tok0])
        last_tok = tok0.copy()
        stats = {"verify_steps": 0, "generated": b, "drafted": 0, "accepted": 0}
        while True:
            live = np.asarray([not done[i] and len(outs[i]) < max_new for i in range(b)])
            if not live.any():
                break
            chunk = draft_chunk(drafter, last_tok, live, lambda i: ctx[i], spec_k)
            remaining = np.asarray([max_new - len(outs[i]) for i in range(b)], np.int64)
            ver.load(chunk=chunk, live=live, remaining=remaining)
            draw_noise(ver.inputs, gen)
            # one transfer for everything the host needs this step
            host = ver.replay().cpu().numpy()
            stats["verify_steps"] += 1
            for i in np.flatnonzero(live):
                new = take_accepted(host[i, :spec_k], host[i, spec_k], remaining[i], eos,
                                    stats, spec_k)
                outs[i].extend(new)
                ctx[i].extend(new)
                last_tok[i] = new[-1]
                if (eos is not None and new[-1] == eos) or len(outs[i]) >= max_new:
                    done[i] = True
        pad = eos if eos is not None else 0
        out = np.full((b, max_new), pad, np.int64)
        for i in range(b):
            out[i, : len(outs[i])] = outs[i][:max_new]
        logits = ver.inputs["last"].clone()
        if self.sanitize:
            check_array("generate_spec.logits_last", logits)
        return GenerationResult(tokens=torch.from_numpy(out), logits_last=logits,
                                steps=stats["verify_steps"], spec_stats=stats)

    # -- generation state ------------------------------------------------------
    @staticmethod
    def snapshot(cache, pos, tokens, block_table=None) -> dict:
        """Generation state copied to the host. On the paged path the cache
        is the block pool, so the block table is part of the state: without
        it the pool's rows are unaddressable."""
        snap = {"cache": tree_map(lambda x: x.detach().to("cpu", copy=True), cache),
                "pos": torch.as_tensor(pos).to("cpu", copy=True).numpy(),
                "tokens": torch.as_tensor(tokens).to("cpu", copy=True)}
        if block_table is not None:
            snap["block_table"] = torch.as_tensor(block_table).to("cpu", copy=True).numpy()
        return snap

    def restore(self, snap: dict):
        """``snapshot``'s state on the engine's device: (cache, pos, tokens),
        and the int32 block table when the snapshot has one."""
        out = (tree_to(snap["cache"], self.device),
               torch.as_tensor(snap["pos"], dtype=torch.long).to(self.device),
               torch.as_tensor(snap["tokens"]).to(self.device))
        if "block_table" in snap:
            return out + (torch.as_tensor(snap["block_table"], dtype=torch.int32)
                          .to(self.device),)
        return out
