"""repro-san in the port (``repro_torch.analysis.sanitizer``/``shadow``, the
``core/quant.py`` tripwires, the serving hooks) held to the reference on
the same inputs, on the CPU, reduced configs:

- the shadow mirrors: the same call sequence gives the same result, or an
  exception of the same type name and message, in both packages;
- ``paged_poison_counts`` equal, integer for integer, to the reference's
  on the same numpy pool, table and positions;
- the quantize/dequantize guards and a corrupt checkpoint: the same
  messages (param path and layer class included) as the reference's;
- ``REPRO_SAN`` arming engines, ``SchedulerCore`` taking the engine's
  setting;
- planted faults (a use-after-free, a leak at finish, NaN in the cache),
  each raising the reference's message;
- mid-flight snapshots (paged and recurrent) restored and resumed: the
  resumed tokens are the serve's own; ``snapshot``/``restore`` round trip;
- the parity sweep over ``SANITIZED_ARCHS`` (``tests/arch_matrix.py``, the
  ledger the shadow-coverage checker audits): sanitized tokens equal the
  port's unsanitized tokens and the reference's sanitized ones (f32
  weights: no int8 rounding, so no .5-tie rule is needed);
- the quantized pools: the port refuses them under sanitize where the
  reference fails (int8: ``OverflowError``; fp8: a false numerics alarm).
"""

import dataclasses
import functools

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from _torch_helpers import numpy_to_jax  # noqa: E402
from arch_matrix import SANITIZED_ARCHS  # noqa: E402
from repro.analysis import sanitizer as jsan  # noqa: E402
from repro.analysis import shadow as jshadow  # noqa: E402
from repro.core import quant as jquant  # noqa: E402
from repro.core.policy import quantize_params as jquantize_params  # noqa: E402
from repro.kernels.ref import paged_poison_counts as jpaged_poison_counts  # noqa: E402
from repro.models import registry as jreg  # noqa: E402
from repro.serving import batching as jbatching  # noqa: E402
from repro.serving import core as jcore  # noqa: E402
from repro.serving import paged as jpaged  # noqa: E402
from repro.serving.engine import InferenceEngine as JEngine  # noqa: E402
from repro_torch import bridge  # noqa: E402
from repro_torch.analysis import sanitizer as tsan  # noqa: E402
from repro_torch.analysis import shadow as tshadow  # noqa: E402
from repro_torch.core import quant as tquant  # noqa: E402
from repro_torch.core.policy import quantize_params  # noqa: E402
from repro_torch.kernels.ref import paged_poison_counts  # noqa: E402
from repro_torch.models import registry  # noqa: E402
from repro_torch.serving import batching  # noqa: E402
from repro_torch.serving.core import RecurrentAdapter, Request, SchedulerCore  # noqa: E402
from repro_torch.serving.engine import InferenceEngine  # noqa: E402
from repro_torch.serving.paged import BlockPool, PagedAdapter, PagedScheduler  # noqa: E402

STEPS = 3
CACHE_LEN = 16
PROMPTS = [[5, 3], [7, 1, 4, 2, 6], [9, 2, 8]]


@pytest.fixture(autouse=True)
def _numerics_isolation():
    """Sanitized engines flip the process-global numerics switch of each
    package; keep every test hermetic."""
    prev = tquant.numerics_checks_enabled(), jquant.numerics_checks_enabled()
    yield
    tquant.set_numerics_checks(prev[0])
    jquant.set_numerics_checks(prev[1])


@functools.lru_cache(maxsize=None)
def _tree(arch: str):
    return bridge.init_params_numpy(registry.load_config(arch).reduced(), seed=5,
                                    norm_scale=0.1)


def _port(arch: str):
    """(model, params on the CPU) of the reduced config."""
    model = registry.build(registry.load_config(arch).reduced())
    return model, bridge.params_from_numpy(_tree(arch), "cpu")


def _engine(arch: str, sanitize, **kw):
    model, params = _port(arch)
    return InferenceEngine(model, params, cache_len=CACHE_LEN, sanitize=sanitize,
                           device="cpu", **kw)


def _jengine(arch: str, sanitize, **kw):
    return JEngine(jreg.build(jreg.load_config(arch).reduced()), numpy_to_jax(_tree(arch)),
                   cache_len=CACHE_LEN, sanitize=sanitize, **kw)


def _requests(mod, prompts=PROMPTS, max_new=None):
    return [mod.Request(i, list(p), max_new=max_new) for i, p in enumerate(prompts)]


def _raised(fn) -> tuple[str, str] | None:
    """(exception type name, message) of ``fn()``, or None if it returns."""
    try:
        fn()
    except Exception as e:  # noqa: BLE001 - the type is what is compared
        return type(e).__name__, str(e)
    return None


def _same_tokens(got, want):
    assert [r.id for r in got] == [r.id for r in want]
    for g, w in zip(got, want):
        np.testing.assert_array_equal(np.asarray(g.tokens), np.asarray(w.tokens))


# ---------------------------------------------------------------------------
# shadow state: the host-side mirrors, call for call against the reference
# ---------------------------------------------------------------------------

def _tracker_double_reserve(m):
    t = m.ShadowBlockTracker(8)
    t.set_context(0)
    return [t.on_alloc([3, 4]), _raised(lambda: t.on_alloc([3])),
            _raised(lambda: t.on_free([5])), _raised(lambda: t.on_free([9]))]


def _tracker_generations(m):
    t = m.ShadowBlockTracker(8)
    t.set_context(1)
    t.on_alloc([2])
    t.on_free([2])
    out = [list(t.generation), t.drain_poison(), t.drain_poison()]
    t.on_alloc([2])                      # recycled: a new generation, the same id
    t.on_free([2])
    t.set_context(0)
    t.on_alloc([2, 6])
    return out + [list(t.generation), t.slot_blocks(0), _raised(lambda: t.on_free([2, 2]))]


def _tracker_leaks(m):
    t = m.ShadowBlockTracker(8)
    t.set_context(1)
    t.on_alloc([6, 3])
    t.set_context(0)
    t.on_alloc([1])
    return [_raised(lambda: t.audit_request(1, "r9")), _raised(lambda: t.audit_request(2, 4)),
            _raised(t.audit_final)]


def _slot_lifecycle(m):
    sh = m.SlotShadow(2, "paged")
    sh.on_admit(0, 11)
    out = [_raised(lambda: sh.on_admit(0, 12)), _raised(lambda: sh.on_finish(1, 0))]
    sh.on_finish(0, 7)
    out += [_raised(lambda: sh.check_frozen([7, 0])), _raised(lambda: sh.check_frozen([9, 0])),
            sh.live_slots(), _raised(lambda: sh.check_snapshot([0])),
            _raised(lambda: sh.on_finish(0, 7))]
    sh.on_admit(0, 13)                   # a frozen slot re-admits
    return out + [sh.live_slots(), _raised(lambda: sh.check_snapshot([0]))]


def _pad_rows(m):
    return [_raised(lambda: m.SlotShadow(2, "paged").check_prefill_group([0], [3], 4)),
            _raised(lambda: m.SlotShadow(2, "recurrent").check_prefill_group([0, 1], [4, 3], 4)),
            _raised(lambda: m.SlotShadow(2, "recurrent").check_prefill_group([1], [4], 4))]


@pytest.mark.parametrize("scenario", [_tracker_double_reserve, _tracker_generations,
                                      _tracker_leaks, _slot_lifecycle, _pad_rows],
                         ids=lambda f: f.__name__.strip("_"))
def test_shadow_matches_reference(scenario):
    got, want = scenario(tshadow), scenario(jshadow)
    assert got == want
    assert any(isinstance(x, tuple) and x[0] == "SanitizerError" for x in got)


def test_poison_constants_match_reference():
    assert tshadow.POISON == jshadow.POISON and tshadow.OVERFLOW_LIMIT == jshadow.OVERFLOW_LIMIT
    assert np.isfinite(tshadow.POISON) and abs(tshadow.POISON) < tshadow.OVERFLOW_LIMIT
    assert issubclass(tshadow.SanitizerError, AssertionError)
    assert tsan.ENV_VAR == jsan.ENV_VAR == "REPRO_SAN"


@pytest.mark.parametrize("seed", range(4))
def test_paged_poison_counts_equal_reference(seed):
    """Random pools with the poison sprinkled over K and V rows, random
    tables (sink entries included) and positions: the counts equal the
    reference's, integer for integer."""
    rng = np.random.default_rng(seed)
    L, NB, BS, KV, hd, b, MB = 2, 9, 4, 2, 8, 3, 4
    k = rng.normal(size=(L, NB, BS, KV, hd)).astype(np.float32)
    v = rng.normal(size=(L, NB, BS, KV, hd)).astype(np.float32)
    for pages in (k, v):
        hit = rng.random((L, NB, BS)) < 0.3
        pages[hit, rng.integers(KV), rng.integers(hd)] = tshadow.POISON
    table = rng.integers(0, NB, size=(b, MB)).astype(np.int32)
    pos = rng.integers(0, MB * BS + 1, size=(b,)).astype(np.int32)
    got = paged_poison_counts(torch.from_numpy(k), torch.from_numpy(v),
                              torch.from_numpy(table), torch.from_numpy(pos), tshadow.POISON)
    want = jpaged_poison_counts(jnp.asarray(k), jnp.asarray(v), jnp.asarray(table),
                                jnp.asarray(pos), jshadow.POISON)
    assert got.dtype == torch.int32 and got.sum() > 0
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_paged_poison_counts_committed_positions_only():
    L, NB, BS, KV, hd = 1, 4, 2, 1, 2
    k = torch.zeros((L, NB, BS, KV, hd))
    v = torch.zeros_like(k)
    k[0, 2, 0] = tshadow.POISON          # physical block 2, in-block position 0
    table = torch.tensor([[2, 0]], dtype=torch.int32)

    def counts(pos):
        return paged_poison_counts(k, v, table, torch.tensor([pos]), tshadow.POISON)

    assert counts(1).tolist() == [[[1, 0]]]      # t = 0 committed: reachable
    assert counts(0).sum() == 0                  # a lookahead block: masked, clean
    v[0, 2, 0] = tshadow.POISON                  # K and V hits count apart
    assert counts(1).tolist() == [[[2, 0]]]


class _Core:
    slots = 2


class _Adapter:
    kind = "paged"

    def __init__(self, pool, table):
        self.pool, self.table = pool, table

    def san_state(self):
        return {"pool": self.pool, "table": self.table}


def _snapshot_hooks(san_mod, pool_cls, request_cls, cache):
    pool = pool_cls(5, 4)
    table = np.zeros((2, 2), np.int32)
    san = san_mod.Sanitizer(_Core())
    san.begin_serve(_Adapter(pool, table), cache)
    san.on_admit(0, request_cls(0, [1, 2]))
    table[0, 0] = pool.alloc(1)[0]
    out = [_raised(lambda: san.on_snapshot([0]))]      # live slot, table == shadow
    table[0, 1] = 3                                    # a mapping the shadow never saw
    out.append(_raised(lambda: san.on_snapshot([0])))
    table[0, 1] = 0
    out.append(_raised(lambda: san.on_snapshot([1])))
    out.append(_raised(lambda: pool.free([table[0, 0], table[0, 0]])))
    return out


def test_sanitizer_snapshot_hooks_match_reference():
    pool = {"k_pages": torch.zeros((1, 5, 4, 1, 2)), "v_pages": torch.zeros((1, 5, 4, 1, 2))}
    got = _snapshot_hooks(tsan, BlockPool, Request, pool)
    want = _snapshot_hooks(jsan, jpaged.BlockPool, jcore.Request, None)
    assert got == want
    assert got[0] is None and "phantom" in got[1][1] and "non-live slot 1" in got[2][1]


# ---------------------------------------------------------------------------
# numerics tripwires: quantize/dequantize boundaries, logits
# ---------------------------------------------------------------------------

def test_check_array_matches_reference():
    x = np.ones((2, 3), np.float32)
    tsan.check_array("ok", torch.from_numpy(x))
    tsan.check_array("ints", torch.ones(4, dtype=torch.int32))    # integer: no-op
    x[1, 2], x[0, 1] = np.nan, 2e30
    got = _raised(lambda: tsan.check_array("logits", torch.from_numpy(x)))
    want = _raised(lambda: jsan.check_array("logits", jnp.asarray(x)))
    assert got == want and r"index (0, 1)" in got[1]


@pytest.mark.parametrize("fmt", ["int8", "int4", "int3", "fp8"])
def test_quantize_guards_match_reference(fmt):
    x = np.random.default_rng(1).normal(size=(4, 64)).astype(np.float32)
    bad = x.copy()
    bad[2, 17] = np.nan
    bad[3, 5] = np.inf
    tf, jf = tquant.get_format(fmt), jquant.get_format(fmt)
    tf.quantize(torch.from_numpy(bad), 32)            # unarmed: passes, as before
    with tquant.numerics_checks(True), jquant.numerics_checks(True):
        got = _raised(lambda: tf.quantize(torch.from_numpy(bad), 32))
        want = _raised(lambda: jf.quantize(jnp.asarray(bad), 32))
        assert got == want and got[0] == "QuantNumericsError"
        assert f"quantize[{fmt}].input" in got[1]
        qt = tf.quantize(torch.from_numpy(x), 32)
        jqt = jf.quantize(jnp.asarray(x), 32)
        scales = qt.scales.clone()
        scales[1, 0] = float("inf")
        corrupt = dataclasses.replace(qt, scales=scales)
        jcorrupt = dataclasses.replace(jqt, scales=jnp.asarray(scales.numpy()))
        got = _raised(lambda: tquant.dequantize(corrupt))
        want = _raised(lambda: jquant.dequantize(jcorrupt))
        assert got == want and f"dequantize[{fmt}].scales" in got[1]
        # the model step's dequantize is not guarded (the reference skips tracers)
        assert not torch.isfinite(tquant.dequantize_unchecked(corrupt)).all()
    tquant.dequantize(corrupt)                        # unarmed


def _first_quantized(cfg, tree, jtree):
    """The reference's first quantized leaf (its flatten order) as a
    '/'-joined path."""
    qp = jquantize_params(jtree, cfg.group_size)
    leaves = jax.tree_util.tree_flatten_with_path(
        qp, is_leaf=lambda x: isinstance(x, jquant.QuantizedTensor))[0]
    return next("/".join(str(k.key) for k in kp) for kp, leaf in leaves
                if isinstance(leaf, jquant.QuantizedTensor))


def _leaf(tree, path: str):
    for k in path.split("/"):
        tree = tree[k]
    return tree


def _poisoned_tree(tree, path: str, index):
    out = jax.tree_util.tree_map(lambda x: x, tree)     # new dicts, the same arrays
    *head, last = path.split("/")
    node = _leaf(out, "/".join(head)) if head else out
    node[last] = node[last].copy()
    node[last][index] = np.nan
    return out


@pytest.mark.parametrize("where", ["first", "stacked"])
def test_corrupt_checkpoint_attributed_like_reference(where):
    """A NaN in a weight: ``quantize_params`` raises the reference's message
    (count, index, param path and layer class); a stacked (L, out, in) leaf
    is checked as one leaf, as the reference's one call checks it."""
    cfg = registry.load_config("tinyllama-1.1b").reduced()
    tree = _tree("tinyllama-1.1b")
    if where == "first":
        path = _first_quantized(cfg, tree, numpy_to_jax(tree))
        bad = _poisoned_tree(tree, path, (0,) * _leaf(tree, path).ndim)
    else:
        path = "layers/mlp/w2"
        bad = _poisoned_tree(tree, path, (1, 3, 40))
    with tquant.numerics_checks(True), jquant.numerics_checks(True):
        got = _raised(lambda: quantize_params(bridge.params_from_numpy(bad, "cpu"),
                                              cfg.group_size))
        want = _raised(lambda: jquantize_params(numpy_to_jax(bad), cfg.group_size))
    assert got == want and got[0] == "QuantNumericsError"
    assert f"[param {path!r}, layer-class" in got[1]


def test_sanitized_engine_rejects_corrupt_checkpoint_at_init():
    model, _ = _port("tinyllama-1.1b")
    bad = bridge.params_from_numpy(_poisoned_tree(_tree("tinyllama-1.1b"), "layers/attn/wo",
                                                  (0, 1, 2)), "cpu")
    with pytest.raises(tquant.QuantNumericsError, match="layer-class attn"):
        InferenceEngine(model, bad, cache_len=CACHE_LEN, quantize=True, sanitize=True,
                        device="cpu")
    tquant.set_numerics_checks(False)
    InferenceEngine(model, bad, cache_len=CACHE_LEN, quantize=True, sanitize=False,
                    device="cpu")                     # unsanitized: silent, as before


def test_generate_checks_final_logits():
    eng = _engine("tinyllama-1.1b", True)
    eng.generate({"tokens": torch.tensor([[5, 3, 1]])}, 3)          # clean
    eng.params["final_norm"].fill_(float("nan"))
    with pytest.raises(tshadow.SanitizerError, match=r"generate.logits_last"):
        eng.generate({"tokens": torch.tensor([[5, 3, 1]])}, 3)
    with pytest.raises(tshadow.SanitizerError, match=r"generate_spec.logits_last"):
        eng.generate({"tokens": torch.tensor([[5, 3, 1, 5, 3, 1]])}, 3, spec_k=2)


# ---------------------------------------------------------------------------
# enablement: engine flag, REPRO_SAN, core inheritance
# ---------------------------------------------------------------------------

def test_env_var_arms_engines(monkeypatch):
    monkeypatch.setenv(tsan.ENV_VAR, "1")
    assert tsan.sanitize_enabled()
    assert _engine("tinyllama-1.1b", None).sanitize
    assert tquant.numerics_checks_enabled()
    monkeypatch.setenv(tsan.ENV_VAR, "0")
    assert not tsan.sanitize_enabled()
    assert not _engine("tinyllama-1.1b", None).sanitize
    monkeypatch.setenv(tsan.ENV_VAR, "")
    assert not tsan.sanitize_enabled()
    monkeypatch.setenv(tsan.ENV_VAR, "1")
    assert not _engine("tinyllama-1.1b", False).sanitize    # explicit beats the environment
    monkeypatch.delenv(tsan.ENV_VAR)
    assert not tsan.sanitize_enabled() and tsan.sanitize_enabled(default=True)


def test_core_takes_engine_sanitize():
    eng = _engine("tinyllama-1.1b", True)
    assert SchedulerCore(eng, PagedAdapter(eng), slots=2).sanitizer is not None
    assert SchedulerCore(eng, PagedAdapter(eng), slots=2, sanitize=False).sanitizer is None
    plain = _engine("tinyllama-1.1b", False)
    assert SchedulerCore(plain, PagedAdapter(plain), slots=2).sanitizer is None
    assert SchedulerCore(plain, PagedAdapter(plain), slots=2, sanitize=True).sanitizer
    assert PagedScheduler(eng, slots=2)._core.sanitizer is not None


# ---------------------------------------------------------------------------
# planted faults, written as the reference's are: each raises its message
# ---------------------------------------------------------------------------

class UafAdapter(PagedAdapter):
    """Frees a live slot's first block but leaves the table mapping it: the
    silent stale-KV read the poison oracle exists to catch."""

    tripped = False

    def before_round(self, pos, live):
        super().before_round(pos, live)
        if not self.tripped:
            s = int(np.flatnonzero(live)[0])
            blk = self._slot_blocks[s][0]
            self.pool.free([blk])        # out-of-band free: pre_round poisons it
            self.tripped = True


class JUafAdapter(jpaged.PagedAdapter):
    tripped = False

    def before_round(self, pos, live):
        super().before_round(pos, live)
        if not self.tripped:
            s = int(np.flatnonzero(live)[0])
            self.pool.free([self._slot_blocks[s][0]])
            self.tripped = True


class LeakOnFinishAdapter(PagedAdapter):
    """Drops the bookkeeping at finish but never returns the blocks."""

    def on_finish(self, s):
        self._slot_blocks[s], self._slot_need[s] = [], 0
        self.table[s, :] = 0
        self._slot_live[s] = False       # everything but pool.free


class JLeakOnFinishAdapter(jpaged.PagedAdapter):
    def on_finish(self, s):
        self._slot_blocks[s], self._slot_need[s] = [], 0
        self.table[s, :] = 0
        self._slot_live[s] = False


class NanCacheAdapter(PagedAdapter):
    """Writes NaN into the KV pool (layer 0, block 2) after a decode round."""

    tripped = False

    def decode_round(self, params, tok, pos, live, steps):
        out = super().decode_round(params, tok, pos, live, steps)
        if not self.tripped:
            self.cache()["k_pages"][0, 2] = float("nan")
            self.tripped = True
        return out


class JNanCacheAdapter(jpaged.PagedAdapter):
    tripped = False

    def decode_round(self, params, tok, cache, pos, live, remaining, keys):
        toks, steps, cache, pos = super().decode_round(params, tok, cache, pos, live,
                                                       remaining, keys)
        if not self.tripped:
            cache = dict(cache)
            cache["k_pages"] = cache["k_pages"].at[0, 2].set(jnp.nan)
            self.tripped = True
        return toks, steps, cache, pos


@pytest.mark.parametrize("fault,reqs,budget,needles", [
    ((UafAdapter, JUafAdapter), [[5, 3, 1, 7]], 6,
     ("use-after-free", "freed physical block", "generation")),
    ((LeakOnFinishAdapter, JLeakOnFinishAdapter), [[5, 3, 1]], 2,
     ("leak — request 0", "still owns block(s)")),
    ((NanCacheAdapter, JNanCacheAdapter), [[5, 3, 1, 7]], 6,
     ("cache leaf ['k_pages']", "(layer) indices [0]")),
], ids=["use_after_free", "leak", "nan_cache"])
def test_planted_fault_raises_reference_message(fault, reqs, budget, needles):
    tcls, jcls = fault
    eng = _engine("tinyllama-1.1b", True)
    core = SchedulerCore(eng, tcls(eng), slots=1, chunk=2)
    got = _raised(lambda: core.serve(_requests(batching, reqs, budget), budget))
    jeng = _jengine("tinyllama-1.1b", True)
    jc = jcore.SchedulerCore(jeng, jcls(jeng), slots=1, chunk=2)
    want = _raised(lambda: jc.serve(_requests(jcore, reqs, budget), budget))
    assert got == want and got[0] == "SanitizerError"
    assert all(n in got[1] for n in needles), got[1]


def test_poison_written_in_place_and_counted():
    """The fill writes the pool's own storage (the replayed programs hold it
    by address), and only freed blocks hold the poison."""
    eng = _engine("tinyllama-1.1b", True)
    sched = PagedScheduler(eng, slots=2, chunk=2)
    core, adapter = sched._core, sched.adapter
    reqs = [Request(0, [5, 3], max_new=1), Request(1, [7, 1, 4, 2, 6], max_new=6),
            Request(2, [9, 2, 8], max_new=3)]
    sched.serve(reqs, 6)
    pool = adapter.cache()
    ptr = pool["k_pages"].data_ptr()
    st = core.sanitizer.stats
    assert st["blocks_poisoned"] > 0 and st["rounds_checked"] == core.rounds
    assert st["poison_reach"] == 0
    hit = (pool["k_pages"] == torch.tensor(tshadow.POISON)).flatten(2).all(-1)
    freed = {b for b, g in enumerate(core.sanitizer.tracker.generation) if g > 0}
    assert set(torch.nonzero(hit[0]).flatten().tolist()) == freed
    sched.serve(reqs, 6)                 # a second serve re-arms on the same storage
    assert adapter.cache()["k_pages"].data_ptr() == ptr


# ---------------------------------------------------------------------------
# snapshots under the sanitizer: mid-flight, restore, resume
# ---------------------------------------------------------------------------

class MidServeSnapPaged(PagedAdapter):
    """Snapshots every live slot once, at the first decode round."""

    def __init__(self, *a, **kw):
        super().__init__(*a, **kw)
        self.snaps = []

    def decode_round(self, params, tok, pos, live, steps):
        if not self.snaps:
            slots = np.flatnonzero(live).tolist()
            self.snaps.append((self.snapshot(slots), pos[slots].copy(), tok[slots].copy()))
        return super().decode_round(params, tok, pos, live, steps)


class MidServeSnapRecurrent(RecurrentAdapter):
    def __init__(self, engine):
        super().__init__(engine)
        self.snaps = []

    def decode_round(self, params, tok, pos, live, steps):
        if not self.snaps:
            slots = np.flatnonzero(live).tolist()
            self.snaps.append((self.snapshot(slots), pos[slots].copy(), tok[slots].copy()))
        return super().decode_round(params, tok, pos, live, steps)


def _resume(decode, tok, pos, steps):
    """Greedy decode ``steps`` tokens from restored state."""
    out = []
    for _ in range(steps):
        logits = decode(tok, pos)
        tsan.check_array("restored.decode.logits", logits)
        tok = logits.argmax(-1)
        pos = pos + 1
        out.append(tok)
    return torch.stack(out, 1)


@pytest.mark.parametrize("arch", ["tinyllama-1.1b", "rwkv6-7b"])
def test_snapshot_midflight_restore_and_resume(arch):
    """A sanitized serve snapshots its live slots at the first round and
    finalizes clean; the snapshot restored on a fresh engine resumes the
    slots' greedy decode with the serve's own next tokens (two steps: the
    blocks the paged table held ahead), and the serve equals an unsanitized
    one."""
    eng = _engine(arch, True)
    paged = arch != "rwkv6-7b"
    adapter = MidServeSnapPaged(eng) if paged else MidServeSnapRecurrent(eng)
    got = SchedulerCore(eng, adapter, slots=2, chunk=2).serve(_requests(batching), 4)
    (snap, pos_s, tok_s), = adapter.snaps
    slots = list(range(len(pos_s)))
    plain = _engine(arch, False)
    want = batching.serve_ragged(plain, _requests(batching), 4,
                                 mode="paged" if paged else "continuous", slots=2, chunk=2)
    _same_tokens(got, want)
    model = plain.model
    if paged:
        for leaf in snap["cache"].values():
            assert torch.isfinite(leaf.float()).all()
        cache, pos, tok, table = plain.restore(
            InferenceEngine.snapshot(snap["cache"], pos_s, tok_s, snap["table"]))
        with torch.inference_mode():
            resumed = _resume(lambda t, p: model.decode_paged(plain.params, t, cache, table,
                                                              p)[0], tok, pos, 2)
    else:
        cache, pos, tok = plain.restore(InferenceEngine.snapshot(snap, pos_s, tok_s))
        with torch.inference_mode():
            resumed = _resume(lambda t, p: model.decode(plain.params, t, cache, p)[0],
                              tok, pos, 2)
    for i, s in enumerate(slots):
        np.testing.assert_array_equal(resumed[i].numpy(), got[s].tokens[1:3])


def test_snapshot_of_dead_slot_raises():
    eng = _engine("tinyllama-1.1b", True)
    sched = PagedScheduler(eng, slots=2, chunk=2)
    sched.serve(_requests(batching, max_new=2), 2)
    with pytest.raises(tshadow.SanitizerError, match="snapshot of non-live slot 0"):
        sched.adapter.snapshot([0])


def test_engine_snapshot_restore_roundtrip_with_block_table():
    cache = {"k": torch.ones((2, 3)), "v": torch.zeros((2, 3))}
    snap = InferenceEngine.snapshot(cache, torch.tensor([4, 1]), torch.tensor([7, 2]),
                                    block_table=np.asarray([[1, 0], [2, 0]]))
    cache["k"].fill_(5.0)                # the snapshot is a copy
    eng = _engine("tinyllama-1.1b", False)
    c2, pos, toks, table = eng.restore(snap)
    np.testing.assert_array_equal(c2["k"].numpy(), np.ones((2, 3)))
    np.testing.assert_array_equal(pos.numpy(), [4, 1])
    np.testing.assert_array_equal(toks.numpy(), [7, 2])
    assert pos.dtype == torch.long and table.dtype == torch.int32
    assert c2["k"].device == pos.device == table.device == eng.device
    np.testing.assert_array_equal(table.numpy(), [[1, 0], [2, 0]])
    assert len(eng.restore(InferenceEngine.snapshot(cache, [0], [0]))) == 3


# ---------------------------------------------------------------------------
# the parity sweep: the sanitizer observes and never perturbs
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", SANITIZED_ARCHS)
def test_sanitized_serve_bit_identical_and_equal_to_reference(arch):
    """Every cache-bearing family serves its preferred mode sanitized with
    the tokens of its unsanitized serve and of the reference's sanitized
    serve, and finalizes with a clean audit."""
    kw = dict(slots=2, chunk=2)
    want = batching.serve_ragged(_engine(arch, False), _requests(batching), STEPS, **kw)
    san = _engine(arch, True)
    got = batching.serve_ragged(san, _requests(batching), STEPS, **kw)
    _same_tokens(got, want)
    ref = jbatching.serve_ragged(_jengine(arch, True), _requests(jbatching), STEPS, **kw)
    _same_tokens(got, ref)


def test_mixed_budgets_exercise_poison_path_cleanly():
    """Early finishes free and poison blocks while others decode on; both
    pool sizes (the default, and one small enough to recycle blocks)."""
    def reqs(mod):
        return [mod.Request(0, [5, 3], max_new=1), mod.Request(1, [7, 1, 4, 2, 6], max_new=6),
                mod.Request(2, [9, 2, 8], max_new=3), mod.Request(3, [4] * 9, max_new=5)]
    for num_blocks in (None, 6):
        kw = dict(mode="paged", slots=2, chunk=2, block_size=4, num_blocks=num_blocks)
        want = batching.serve_ragged(_engine("tinyllama-1.1b", False), reqs(batching), 6, **kw)
        got = batching.serve_ragged(_engine("tinyllama-1.1b", True), reqs(batching), 6, **kw)
        _same_tokens(got, want)


def test_sanitized_speculative_serve_identical():
    """Verify rounds are checked too; the tokens stay the same."""
    kw = dict(slots=2, chunk=2, spec_k=2)
    for mode in ("paged", "continuous"):
        want = batching.serve_ragged(_engine("tinyllama-1.1b", False), _requests(batching, max_new=5),
                                     5, mode=mode, **kw)
        san = _engine("tinyllama-1.1b", True)
        got = batching.serve_ragged(san, _requests(batching, max_new=5), 5, mode=mode, **kw)
        _same_tokens(got, want)


# ---------------------------------------------------------------------------
# quantized pools: refused where the reference fails
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("kv_quant,ref_error", [
    ("int8", ("OverflowError", "out of bounds for int8")),
    ("fp8", ("SanitizerError", "non-finite/overflow values in cache leaf ['k_pages']")),
])
def test_quantized_pool_refused_where_reference_fails(kv_quant, ref_error):
    eng = _engine("tinyllama-1.1b", True, kv_quant=kv_quant)
    got = _raised(lambda: batching.serve_ragged(eng, _requests(batching), STEPS, mode="paged",
                                                slots=2, chunk=2))
    assert got[0] == "NotImplementedError"
    assert "poison" in got[1] and "OverflowError for int8" in got[1] \
        and "NaN for float8_e4m3fn" in got[1]
    reqs = [jcore.Request(0, [5, 3], max_new=1), jcore.Request(1, [7, 1, 4, 2, 6], max_new=6),
            jcore.Request(2, [9, 2, 8], max_new=3)]
    want = _raised(lambda: jbatching.serve_ragged(_jengine("tinyllama-1.1b", True,
                                                           kv_quant=kv_quant),
                                                  reqs, 6, mode="paged", slots=2, chunk=2))
    assert want[0] == ref_error[0] and ref_error[1] in want[1], want
    # the quantized pool serves unsanitized, and the contiguous cache sanitized
    batching.serve_ragged(_engine("tinyllama-1.1b", False, kv_quant=kv_quant),
                          _requests(batching), STEPS, mode="paged", slots=2, chunk=2)
    batching.serve_ragged(eng, _requests(batching), STEPS, mode="continuous", slots=2, chunk=2)
