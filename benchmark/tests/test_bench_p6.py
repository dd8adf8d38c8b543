"""The P6 serve cell on the CPU at a tiny size (the look for a card
skipped), and its new readers on synthetic records.

- ``x6.serve.b32`` (``offline_batch`` on ``yolov5x6_seg``, its width cut
  for the CPU) runs correct, traced;
- ``seg_head_ms.serve`` and ``p6_ms.serve`` read the program's device
  spans; each reads nothing where its source is absent.
"""

import copy
import time

import pytest
import torch

from benchmark import run as R
from benchmark.harness import cell as C

X6 = "x6.serve.b32"
SEED = 2147483671


@pytest.fixture
def tiny_x6(monkeypatch):
    """The cell at a size the CPU runs in seconds: 128-pixel frames of
    96x128 in batches of 2, x6 at width 0.125, float32; the cell's own
    limits."""
    torch.set_num_threads(2)
    workload, config = C.workload, C.config

    def wl(name):
        w = copy.deepcopy(workload(name))
        w["params"].update(batch=2, pool=2, frame_hw=[96, 128], sample=1,
                           sample_from=2, trace_at=1, trace_calls=2,
                           warmup=1)
        return w

    def cf(name):
        c = copy.deepcopy(config(name))
        c.update(imgsz=128, dtype="float32")
        c["init"]["bn_calibration_frames"] = 2
        c["model"]["width_multiple"] = 0.125
        return c

    monkeypatch.setattr(C, "workload", wl)
    monkeypatch.setattr(C, "config", cf)
    return C


def test_x6_traced_run_is_correct(tiny_x6):
    res = R.execute(X6, SEED, 1.0, True, torch.device("cpu"),
                    time.perf_counter())
    assert res["correct"], res["checks"]
    assert res["device"]["window_s"] > 0
    # on the CPU the device spans hold no device time: nothing to read
    assert "p6_ms.serve" not in res["metrics"]


class _Span:
    def __init__(self, name, device_ms):
        self.name, self.device_ms = name, device_ms


@pytest.mark.parametrize("metric,span", [("seg_head_ms.serve",
                                          "forward.seg_head"),
                                         ("p6_ms.serve", "forward.p6")])
def test_device_span_readers(monkeypatch, metric, span):
    from desenet_tpu_torch.utils import profiling

    ring = [_Span(span, 1.5), _Span(span, 2.5), _Span("other", 9.0),
            _Span(span, None)]
    monkeypatch.setattr(profiling, "spans", lambda name=None: [
        s for s in ring if name is None or s.name == name])
    reader = C.load_module("metrics", metric)
    assert reader.read({"calls": 2}) == pytest.approx(2.0)
    assert reader.read({}) is None
    ring[:] = [_Span("other", 1.0)]
    assert reader.read({"calls": 2}) is None
