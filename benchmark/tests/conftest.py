"""Tests of the benchmark itself, on the CPU (``cuda``-marked ones run
only on a card): ``python -m pytest benchmark/tests -q``."""

import copy
import sys
from pathlib import Path

import pytest

sys.path.insert(0, str(Path(__file__).resolve().parents[2]))


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "cuda: needs a CUDA card; skips without one")


@pytest.fixture
def needs_card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")


@pytest.fixture
def tiny(monkeypatch):
    """Every cell at a size the CPU runs in seconds: 128-pixel frames of
    96x128, batches of 2 from a pool of 2, the online rate 8 a second
    into buckets of up to 4, training batches of 4, float32; the cells'
    own limits."""
    import torch

    from benchmark.harness import cell as C

    torch.set_num_threads(4)
    workload, config = C.workload, C.config

    def wl(name):
        w = copy.deepcopy(workload(name))
        p = w["params"]
        if w["driver"] == "offline_batch":
            p.update(batch=2, pool=2, frame_hw=[96, 128], sample=1,
                     sample_from=2, trace_at=1, trace_calls=2, warmup=1)
        elif w["driver"] == "train_step":
            p.update(batch=4, pool=3, max_targets=8, trace_at=0,
                     trace_calls=1)
        else:
            p.update(rate=8.0, pool=8, frame_hw=[96, 128], max_batch=4,
                     sample=6, trace_at_s=0.5, trace_s=0.5, drain_s=20.0)
        return w

    def cf(name):
        c = copy.deepcopy(config(name))
        c.update(imgsz=128, dtype="float32")
        c["init"]["bn_calibration_frames"] = 2
        return c

    monkeypatch.setattr(C, "workload", wl)
    monkeypatch.setattr(C, "config", cf)
    return C
