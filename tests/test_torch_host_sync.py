"""The port's host-sync checker (``repro_torch.analysis.host_sync``): it
flags a per-step ``bool(t.any())`` in a round's ``for`` loop (the paged
round's form before its repair), a sync inside a captured function and a
serve loop over its per-round budget, a per-row ``.item()`` in the
speculative loops (``SchedulerCore.serve``'s verify round and
``InferenceEngine._generate_spec``), and finds nothing in the port's
``serving/`` package, whose rounds and verify steps make one host transfer
each."""

import ast
from pathlib import Path

import pytest

pytest.importorskip("torch")

from repro_torch.analysis import HostSyncChecker, run_analysis  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
SCHED = "src/repro_torch/serving/paged.py"      # matches the scheduler-file globs

# the paged round before the repair: one host read of an EOS flag a step
PER_STEP_ROUND = '''
def decode_round(self, params, tok, cache, pos, live, steps):
    table = torch.tensor(self.table, device=self.engine.device)
    model, sample, eos = self.engine.model, self.core.sample, self.engine.eos_id
    toks = []
    for _ in range(steps):
        logits, cache = model.decode_paged(params, tok, cache, table, pos)
        tok = torch.where(live, sample(logits), tok)     # frozen slots keep tok
        pos = torch.where(live, pos + 1, pos)            # ...and their position
        toks.append(tok)
        if eos is not None and bool((live & (tok == eos)).any()):
            break
    return torch.stack(toks), len(toks), cache
'''

REPAIRED_ROUND = '''
def decode_round(self, params, tok, pos, live, steps):
    st, model, sample, eos = self._state(), self.engine.model, self.core.sample, self.eos

    def step(tok, pos, live, stopped, n, table, cache):
        act = live & ~stopped
        logits, _ = model.decode_paged(params, tok, cache, table, pos)
        tok.copy_(torch.where(act, sample(logits), tok))
        pos.copy_(torch.where(act, pos + 1, pos))
        n.add_((~stopped).long())
        if eos is not None:
            stopped |= (act & (tok == eos)).any()

    prog = self.engine.graphs.program("paged.decode", self._key, step, lambda: {})
    return replay_round(prog, st, tok, pos, live, steps, table=self.table)
'''

SERVE_LOOP = '''
def serve(self, adapter, B):
    while pending or live.any():
        first = torch.cat(staged).tolist()
        toks_d, n_d = adapter.decode_round(params, tok, pos, live, steps)
        host = torch.cat([n_d.expand(1, B), toks_d]).cpu().numpy()
        steps = int(host[0, 0])
        {extra}
'''


# the speculative round's shape: one transfer of the verify step's output
SPEC_ROUND = '''
def serve(self, adapter, B):
    while pending or live.any():
        first = torch.cat(staged).tolist()
        if self.spec_k is not None:
            chunk_np = draft_chunk(self.drafter, tok, live, context, K)
            out_d = adapter.verify_round(params, chunk_np, pos, live, remaining)
            host = out_d.cpu().numpy()
            for s in np.flatnonzero(live):
                {per_row}
            continue
        toks_d, n_d = adapter.decode_round(params, tok, pos, live, steps)
        host = torch.cat([n_d.expand(1, B), toks_d]).cpu().numpy()
'''

SPEC_GENERATE = '''
def _generate_spec(self, st, ver, gen):
    tok0 = st["tok"].cpu().numpy()
    while True:
        if not live.any():
            break
        ver.load(chunk=chunk, live=live, remaining=remaining)
        host = ver.replay().cpu().numpy()
        for i in np.flatnonzero(live):
            {per_row}
'''


def _findings(source: str, path: str = SCHED) -> list[str]:
    return [f.render() for f in HostSyncChecker().check_file(path, ast.parse(source), source)]


def test_flags_per_step_eos_read_in_round_loop():
    found = _findings(PER_STEP_ROUND)
    assert len(found) == 1
    line = 1 + PER_STEP_ROUND.splitlines().index(
        "        if eos is not None and bool((live & (tok == eos)).any()):")
    assert f"paged.py:{line}:" in found[0] and "for loop of `decode_round`" in found[0]


@pytest.mark.parametrize("sync", ["int(tok.max())", "tok.sum().item()", "x_d.tolist()",
                                  "torch.cuda.synchronize()", "float(logits[0, 0])",
                                  "tok.cpu()"])
def test_flags_each_sync_kind_in_a_step_loop(sync):
    src = ("def round(model, tok, steps):\n"
           "    for _ in range(steps):\n"
           "        logits = model.decode(tok)\n"
           "        tok = torch.argmax(logits, -1)\n"
           f"        v = {sync}\n")
    assert len(_findings(src)) == 1


def test_repaired_round_is_clean():
    assert _findings(REPAIRED_ROUND) == []


def test_flags_sync_inside_captured_function_anywhere():
    src = REPAIRED_ROUND.replace("n.add_((~stopped).long())",
                                 "n.add_(int(stopped.sum().item()))")
    found = _findings(src, path="src/repro_torch/models/anything.py")
    assert len(found) == 1 and "inside captured `step`" in found[0]


def test_step_loop_rule_applies_to_scheduler_files_only():
    assert _findings(PER_STEP_ROUND, path="tests/tool.py") == []


def test_serve_loop_budget():
    assert _findings(SERVE_LOOP.format(extra="pass")) == []
    found = _findings(SERVE_LOOP.format(extra="check = toks_d.sum().item()"))
    assert len(found) == 1 and "3 host syncs on one path" in found[0]


def test_chained_transfer_counts_once_and_host_values_stay_clean():
    src = SERVE_LOOP.format(extra="more = int(host[1, 0]) + len(first)")
    assert _findings(src) == []


@pytest.mark.parametrize("loop,path", [(SPEC_ROUND, "src/repro_torch/serving/core.py"),
                                       (SPEC_GENERATE, "src/repro_torch/serving/engine.py")],
                         ids=["serve", "generate"])
def test_speculative_loops_one_transfer_a_step(loop, path):
    """The speculative loops pass with one transfer a verify step (the host
    copy's rows read on the host); a per-row ``.item()`` of the device
    output inside the row loop is flagged."""
    clean = loop.format(per_row="n = int(host[s, -1])")
    assert _findings(clean, path) == []
    per_row = loop.format(per_row="n = out_d[s, -1].item()" if "out_d" in loop
                          else "n = ver.replay()[i, -1].item()")
    found = _findings(per_row, path)
    assert len(found) == 1 and "for loop of" in found[0] and ".item()" in found[0]


def test_speculative_round_over_budget():
    """A second transfer on the verify round's path (after the admission
    wave's and the round's) is over the serve loop's budget."""
    clean = SPEC_ROUND.format(per_row="n = int(host[s, -1])")
    twice = clean.replace("            host = out_d", "            extra = out_d.sum().item()\n"
                          "            host = out_d", 1)
    found = _findings(twice, "src/repro_torch/serving/core.py")
    assert len(found) == 1 and "3 host syncs on one path" in found[0], found


def test_port_serving_package_is_clean():
    found = run_analysis([HostSyncChecker()], ["src/repro_torch/serving"], str(ROOT))
    assert not found, "\n".join(f.render() for f in found)


def test_whole_port_is_clean():
    found = run_analysis([HostSyncChecker()], ["src/repro_torch", "chip_smoke.py"], str(ROOT))
    assert not found, "\n".join(f.render() for f in found)
