"""Data pipeline: deterministic, restartable, per-host shardable token
streams (a copy of ``repro/data/pipeline.py``, array for array).

Two sources:
  * SyntheticLM   -- seeded Zipfian token stream (the default: nothing is
                     downloaded)
  * ByteCorpus    -- byte-level tokenization of a text blob (tokenizer-free)

The iterator state is one integer (step) + the static config, so a
checkpoint stores it as ``extra["data_step"]``. Batches are numpy arrays;
the training loop moves them to the device.
"""

from __future__ import annotations

import dataclasses

import numpy as np


@dataclasses.dataclass(frozen=True)
class DataConfig:
    vocab_size: int
    seq_len: int
    global_batch: int
    seed: int = 0
    num_hosts: int = 1
    host_index: int = 0

    @property
    def host_batch(self) -> int:
        assert self.global_batch % self.num_hosts == 0
        return self.global_batch // self.num_hosts


class SyntheticLM:
    """Zipf-distributed tokens with a learnable bigram-ish structure: token
    t+1 = (a*t + noise) mod V so a model can actually reduce loss on it."""

    def __init__(self, cfg: DataConfig):
        self.cfg = cfg

    def batch_at(self, step: int) -> dict[str, np.ndarray]:
        cfg = self.cfg
        rng = np.random.default_rng((cfg.seed, step, cfg.host_index))
        b, s = cfg.host_batch, cfg.seq_len
        first = rng.zipf(1.3, size=(b, 1)).clip(max=cfg.vocab_size - 1)
        noise = rng.integers(0, 3, size=(b, s))
        toks = np.zeros((b, s + 1), np.int64)
        toks[:, :1] = first
        for i in range(s):
            toks[:, i + 1] = (toks[:, i] * 31 + 7 + noise[:, i]) % cfg.vocab_size
        return {
            "tokens": toks[:, :-1].astype(np.int32),
            "labels": toks[:, 1:].astype(np.int32),
        }

    def __iter__(self):
        step = 0
        while True:
            yield self.batch_at(step)
            step += 1


class ByteCorpus:
    """Byte-level LM over a text blob; vocab 256 (+pad to model vocab ok)."""

    def __init__(self, text: bytes, cfg: DataConfig):
        self.data = np.frombuffer(text, dtype=np.uint8).astype(np.int32)
        self.cfg = cfg
        if len(self.data) < cfg.seq_len + 1:
            raise ValueError("corpus shorter than one sequence")

    def batch_at(self, step: int) -> dict[str, np.ndarray]:
        cfg = self.cfg
        rng = np.random.default_rng((cfg.seed, step, cfg.host_index))
        b, s = cfg.host_batch, cfg.seq_len
        starts = rng.integers(0, len(self.data) - s - 1, size=b)
        toks = np.stack([self.data[i : i + s] for i in starts])
        labs = np.stack([self.data[i + 1 : i + s + 1] for i in starts])
        return {"tokens": toks, "labels": labs}

    def __iter__(self):
        step = 0
        while True:
            yield self.batch_at(step)
            step += 1


def make_source(name: str, cfg: DataConfig, text: bytes | None = None):
    if name == "synthetic":
        return SyntheticLM(cfg)
    if name == "bytes":
        assert text is not None
        return ByteCorpus(text, cfg)
    raise ValueError(name)
