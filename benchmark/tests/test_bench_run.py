"""run.py without a card, and the run's loaded-module check."""

import os
import shutil
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]


def _run(cwd, *extra):
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    return subprocess.run(
        [sys.executable, "benchmark/run.py", "--workload", "s.serve.b128",
         "--seed", "2147483651", "--seconds", "1", *extra],
        cwd=cwd, env=env, capture_output=True, text=True, timeout=300)


def test_no_card_exits_nonzero_with_no_result():
    r = _run(ROOT)
    assert r.returncode == 2, r.stderr
    assert r.stdout.strip() == ""
    assert "CUDA card" in r.stderr


def test_benchmark_alone_exits_nonzero(tmp_path):
    """A directory with only BENCHMARK.json and benchmark/ (no program)."""
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path)
    shutil.copytree(ROOT / "benchmark", tmp_path / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__", ".cache"))
    r = _run(tmp_path)
    assert r.returncode != 0
    assert r.stdout.strip() == ""


def test_forbidden_modules_are_compared_whole(monkeypatch):
    sys.path.insert(0, str(ROOT))
    from benchmark import run

    monkeypatch.setitem(sys.modules, "desenet_tpu_torch_x", object())
    assert "desenet_tpu" not in run.loaded_forbidden()
    monkeypatch.setitem(sys.modules, "flax.core", object())
    assert "flax" in run.loaded_forbidden()
