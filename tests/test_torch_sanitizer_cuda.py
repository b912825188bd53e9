"""repro-san on the card: the sanitized paged serve replays its captured
programs (``serving/graphs.py``) over the pool the sanitizer poisons in
place. Every test needs a CUDA device and ``nvcc`` and skips without them;
the file imports neither JAX nor the reference package:

    python -m pytest -q -m cuda tests/test_torch_sanitizer_cuda.py
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.analysis.shadow import POISON, SanitizerError  # noqa: E402
from repro_torch.kernels import paged_attn as paged_kern  # noqa: E402
from repro_torch.models.registry import build, load_config  # noqa: E402
from repro_torch.serving.core import Request, SchedulerCore  # noqa: E402
from repro_torch.serving.engine import InferenceEngine  # noqa: E402
from repro_torch.serving.paged import PagedAdapter, PagedScheduler  # noqa: E402

pytestmark = pytest.mark.cuda

SERVE = dict(slots=2, chunk=2, block_size=8)


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device and nvcc (run on the GPU machine)")
    return torch.device("cuda", 0)


def _engine(dev, sanitize):
    cfg = load_config("tinyllama-1.1b").reduced()
    model = build(cfg)
    return InferenceEngine(model, model.init(seed=3, device=dev), cache_len=40, quantize=True,
                           sanitize=sanitize, device=dev)


def _requests():
    budgets = [1, 9, 4, 6, 2]
    prompts = [[5, 3], [7, 1, 4, 2, 6], [9, 2, 8], list(range(1, 12)), [4] * 6]
    return [Request(i, p, max_new=b) for i, (p, b) in enumerate(zip(prompts, budgets))]


def test_sanitized_paged_serve_equals_unsanitized(dev):
    """The tokens of a sanitized serve (replayed programs, poison fills,
    per-round checks) equal an unsanitized serve's; the pool was poisoned,
    every round checked, and the paged kernel ran."""
    want = PagedScheduler(_engine(dev, False), **SERVE).serve(_requests(), 9)
    sched = PagedScheduler(_engine(dev, True), **SERVE)
    sched.serve(_requests(), 9)                     # captures the programs
    paged_kern.reset_launches()
    got = sched.serve(_requests(), 9)               # replays them
    assert paged_kern.LAUNCHES["paged_attn"] > 0
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.tokens, w.tokens)
    stats = sched._core.sanitizer.stats
    assert stats["blocks_poisoned"] > 0 and stats["poison_reach"] == 0
    assert stats["rounds_checked"] == sched.last_rounds


class UafAdapter(PagedAdapter):
    """Frees a live slot's first block but leaves the table mapping it."""

    tripped = False

    def before_round(self, pos, live):
        super().before_round(pos, live)
        if not self.tripped:
            s = int(np.flatnonzero(live)[0])
            self.pool.free([self._slot_blocks[s][0]])     # pre_round poisons it
            self.tripped = True


def test_in_place_poison_seen_by_the_next_replayed_decode(dev):
    """Once the programs are captured, a planted use-after-free is poisoned
    in the pool's own storage, and the next replayed decode round reaches
    it: the sanitizer raises with the block and its generation."""
    eng = _engine(dev, True)
    PagedScheduler(eng, **SERVE).serve(_requests(), 9)    # captures the programs
    decode = eng.graphs.last["paged.decode"]
    assert decode.graph is not None
    adapter = UafAdapter(eng, block_size=SERVE["block_size"])
    core = SchedulerCore(eng, adapter, slots=SERVE["slots"], chunk=SERVE["chunk"])
    with pytest.raises(SanitizerError, match=r"use-after-free.*generation 1") as ei:
        core.serve([Request(0, [5, 3, 1, 7], max_new=6)], 6)
    assert "freed physical block" in str(ei.value)
    assert eng.graphs.last["paged.decode"] is decode      # the captured decode replayed
    pool = adapter.cache()
    assert (pool["k_pages"] == torch.tensor(POISON, dtype=pool["k_pages"].dtype,
                                            device=dev)).any()
