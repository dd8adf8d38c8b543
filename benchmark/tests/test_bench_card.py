"""On a card only (``cuda`` marker; skips here): one short run of each
cell through ``run.py``, which must print a correct result.

    python -m pytest benchmark/tests/test_bench_card.py -q   # on the card
"""

import json
import subprocess
import sys
from pathlib import Path

import pytest

from benchmark.harness import cell as C

ROOT = Path(__file__).resolve().parents[2]
CELLS = [w["name"] for w in C.manifest()["workloads"]]


@pytest.mark.cuda
@pytest.mark.parametrize("cell", CELLS)
def test_short_run_is_correct(needs_card, cell):
    r = subprocess.run(
        [sys.executable, "benchmark/run.py", "--workload", cell, "--seed",
         "2147483699", "--seconds", "3", "--trace", "0"],
        cwd=ROOT, capture_output=True, text=True, timeout=600)
    assert r.returncode == 0, r.stderr[-2000:]
    res = json.loads(r.stdout.strip().splitlines()[-1])
    assert res["correct"], res["checks"]
    assert res["device"]["platform"] == "gpu"
