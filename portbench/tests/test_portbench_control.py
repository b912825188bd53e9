"""The control of ``correct`` on the card: the program with its own int4
weight path switched on (the precision below the configuration's int8),
every cell at its own size, three seeds. Each run has to come out not
correct. Run on the card with

    python -m pytest -q -m cuda portbench/tests/test_portbench_control.py
"""

from __future__ import annotations

import json
import subprocess
import sys

import pytest

from portbench.tests._tiny import CELLS, ROOT

SEEDS = (2_900_000_101, 2_900_000_202, 2_900_000_303)


@pytest.mark.cuda
@pytest.mark.parametrize("name", CELLS)
def test_int4_control_is_not_correct(name):
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the control runs the cell at its own size")
    for seed in SEEDS:
        out = subprocess.run(
            [sys.executable, "portbench/run.py", "--workload", name, "--seed", str(seed),
             "--seconds", "1", "--trace", "0", "--weight-format", "int4"],
            cwd=ROOT, capture_output=True, text=True, timeout=900)
        assert out.returncode == 0, out.stderr[-3000:]
        res = json.loads(out.stdout.strip().splitlines()[-1])
        print(name, seed, json.dumps(res["checks"]))
        assert not res["correct"], res["checks"]
