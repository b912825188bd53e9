"""The system under test: the port's engine, driven through its entries.

A mix names its entry: ``generate`` (``InferenceEngine.generate``, the
requests of a call right-padded to their power-of-two bucket with their true
``lengths``) or ``serve_ragged`` in the mix's ``mode`` (continuous or paged).
From the program the harness takes the engine, its entries, and its
counters: the schedulers' ``last_decode_steps`` and the programs'
``GraphCache.stats()``.
"""

from __future__ import annotations

import numpy as np
import torch

from repro_torch.configs.base import MLAConfig, ModelConfig, MoEConfig
from repro_torch.models.registry import build
from repro_torch.serving.batching import Request, serve_ragged, slot_scheduler
from repro_torch.serving.engine import InferenceEngine
from repro_torch.serving.paged import paged_scheduler


def bucket_length(n: int, minimum: int = 8) -> int:
    """The power-of-two bucket of an n-token prompt (a frozen copy of the
    port's rule in ``serving/core.py``)."""
    b = minimum
    while b < n:
        b *= 2
    return b


def model_config(shape: dict) -> ModelConfig:
    kw = {k: v for k, v in shape.items() if k not in ("mla", "moe")}
    return ModelConfig(**kw, mla=MLAConfig(**shape["mla"]) if shape.get("mla") else None,
                       moe=MoEConfig(**shape["moe"]) if shape.get("moe") else None)


class System:
    """One engine over the given float weights, quantized by the engine's own
    set-up to ``weight_format``."""

    def __init__(self, shape: dict, mix: dict, params: dict, weight_format: str, device):
        self.mix = mix
        self.entry = mix["entry"]
        if self.entry not in ("generate", "serve_ragged"):
            raise ValueError(f"unknown entry {self.entry!r}")
        self.engine = InferenceEngine(build(model_config(shape)), params,
                                      cache_len=mix["cache_len"], quantize=weight_format,
                                      device=device)
        self.decode_steps = 0           # decode steps of the last call

    def _sched(self):
        m = self.mix
        if m["mode"] == "paged":
            return paged_scheduler(self.engine, slots=m["slots"], chunk=m["chunk"],
                                   block_size=m["block_size"])
        return slot_scheduler(self.engine, slots=m["slots"], chunk=m["chunk"])

    def call(self, reqs) -> list[list[int]]:
        """Serve one call's requests; returns each one's delivered tokens."""
        if self.entry == "generate":
            n = max(len(r.tokens) for r in reqs)
            length = bucket_length(n) if self.mix.get("bucket_prompts") else n
            toks = np.zeros((len(reqs), length), np.int64)
            for i, r in enumerate(reqs):
                toks[i, : len(r.tokens)] = r.tokens
            lens = np.asarray([len(r.tokens) for r in reqs], np.int64)
            budget = max(r.max_new for r in reqs)
            res = self.engine.generate({"tokens": toks}, budget, lengths=lens)
            self.decode_steps = res.steps
            out = np.asarray(res.tokens)
            return [out[i, : r.max_new].tolist() for i, r in enumerate(reqs)]
        m = self.mix
        resp = serve_ragged(self.engine, [Request(r.id, list(r.tokens), r.max_new) for r in reqs],
                            max(r.max_new for r in reqs), mode=m["mode"], slots=m["slots"],
                            chunk=m["chunk"], block_size=m.get("block_size", 8))
        self.decode_steps = self._sched().last_decode_steps
        return [x.tokens[: x.length].tolist() for x in resp]

    def warm(self, calls) -> None:
        """Capture every program the calls will replay: one short generate
        per bucket, or every serve call once."""
        if self.entry == "generate":
            seen = set()
            for reqs in calls:
                key = bucket_length(max(len(r.tokens) for r in reqs)), len(reqs)
                if key not in seen:
                    seen.add(key)
                    self.call([type(r)(r.id, r.tokens, 2) for r in reqs])
        else:
            for reqs in calls:
                self.call(reqs)
        if self.engine.device.type == "cuda":
            torch.cuda.synchronize()

    def program_stats(self) -> dict[str, float]:
        """Programs built so far and their warm-up plus capture seconds."""
        st = self.engine.graphs.stats()
        return {"builds": sum(s["builds"] for s in st.values()),
                "capture_s": sum(s["warmup_s"] + s["capture_s"] for s in st.values())}

    def close(self) -> None:
        self.engine = None
