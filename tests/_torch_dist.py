"""Multi-process helpers for the port's placement tests: N gloo ranks on the
CPU, each a subprocess that meets the others through a ``FileStore`` in the
test's ``tmp_path`` (no socket), one thread a rank, with a timeout of their
own; and the reference package on N fake host devices in a subprocess
(``XLA_FLAGS=--xla_force_host_platform_device_count``). A collective that
one rank skips blocks the others; the timeout then names the ranks that
never finished."""

from __future__ import annotations

import json
import os
import subprocess
import sys
import textwrap
import time

REPO_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

# the head of every rank's script: argv = rank, world, store path, args...
RANK_HEAD = textwrap.dedent("""
    import json, sys
    import numpy as np
    import torch
    import torch.distributed as dist
    sys.path[:0] = ["src", "tests"]
    RANK, WORLD, STORE = int(sys.argv[1]), int(sys.argv[2]), sys.argv[3]
    ARGS = sys.argv[4:]
    torch.set_num_threads(1)
    dist.init_process_group("gloo", store=dist.FileStore(STORE, WORLD), rank=RANK,
                            world_size=WORLD)
""")

JAX_HEAD = textwrap.dedent("""
    import json, os, sys
    os.environ["XLA_FLAGS"] = f"--xla_force_host_platform_device_count={sys.argv[1]}"
    os.environ["JAX_PLATFORMS"] = "cpu"
    sys.path[:0] = ["src", "tests"]
    import numpy as np
    import jax
    import jax.numpy as jnp
    N_DEVICES = int(sys.argv[1])
    ARGS = sys.argv[2:]
""")


def subprocess_env() -> dict:
    """The environment of a test subprocess: the repo's sources, one thread."""
    env = {k: v for k, v in os.environ.items() if k in ("PATH", "HOME", "TMPDIR", "LANG")}
    env.update(PYTHONPATH="src", OMP_NUM_THREADS="1", JAX_PLATFORMS="cpu")
    return env


def run_ranks(body: str, world: int, tmp_path, *args, timeout: float = 240) -> list[str]:
    """Run ``RANK_HEAD + body`` as ``world`` gloo ranks; returns each rank's
    stdout. Fails naming the ranks that did not finish within ``timeout``
    seconds (all are then killed) or that exited non-zero."""
    store = tmp_path / f"store_{time.monotonic_ns()}"
    script = RANK_HEAD + textwrap.dedent(body)
    procs = [subprocess.Popen(
        [sys.executable, "-c", script, str(r), str(world), str(store), *map(str, args)],
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True, cwd=REPO_ROOT,
        env=subprocess_env())
        for r in range(world)]
    deadline = time.monotonic() + timeout
    outs: list = [None] * world
    hung = []
    for r, p in enumerate(procs):
        try:
            outs[r] = p.communicate(timeout=max(1.0, deadline - time.monotonic()))
        except subprocess.TimeoutExpired:
            hung.append(r)
    if hung:
        for p in procs:
            p.kill()
        for r in hung:
            outs[r] = procs[r].communicate()
        raise AssertionError(f"ranks {hung} of {world} hung past {timeout} s; their stderr:\n"
                             + "\n".join(outs[r][1][-2000:] for r in hung))
    bad = [r for r, p in enumerate(procs) if p.returncode != 0]
    assert not bad, f"ranks {bad} of {world} failed:\n" + "\n".join(
        f"--- rank {r}\n{outs[r][0][-2000:]}\n{outs[r][1][-4000:]}" for r in bad)
    return [o[0] for o in outs]


def run_jax(body: str, devices: int, *args, timeout: float = 600) -> str:
    """Run ``JAX_HEAD + body`` on ``devices`` fake host devices; its stdout."""
    proc = subprocess.run(
        [sys.executable, "-c", JAX_HEAD + textwrap.dedent(body), str(devices), *map(str, args)],
        capture_output=True, text=True, timeout=timeout, cwd=REPO_ROOT, env=subprocess_env())
    assert proc.returncode == 0, proc.stdout[-2000:] + proc.stderr[-4000:]
    return proc.stdout


def last_json(out: str):
    return json.loads(out.strip().splitlines()[-1])
