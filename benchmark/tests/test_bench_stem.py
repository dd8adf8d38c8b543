"""The served stem's two readers on synthetic records:
``stem_fused_pct.serve``, the share of traced forwards whose row 0 took
the served stem (counters ``stem.fused`` and ``stem.plain``), and
``stem_ms.serve``, the device ms a call inside the spans ``forward.stem``;
each reads nothing where the program recorded none (a program without the
served stem)."""

import pytest

from benchmark.harness import cell as C


def read(name, records):
    return C.load_module("metrics", name).read(records)


@pytest.fixture
def counting():
    from desenet_tpu_torch.utils import profiling

    profiling.reset()
    profiling.set_tracing(True)
    yield profiling
    profiling.set_tracing(False)
    profiling.reset()


def test_fused_pct_reads_the_share_of_fused_stems(counting):
    for _ in range(3):
        counting.count("stem.fused", 1)
    counting.count("stem.plain", 1)
    assert read("stem_fused_pct.serve", {"calls": 4}) == pytest.approx(75.0)
    assert read("stem_fused_pct.serve", {}) is None  # no traced calls
    counting.reset()
    counting.count("stem.plain", 2)
    assert read("stem_fused_pct.serve", {"calls": 2}) == 0.0


def test_fused_pct_reads_nothing_without_the_counters(counting):
    counting.count("epilogue.fused", 70)
    assert read("stem_fused_pct.serve", {"calls": 2}) is None


class _Span:
    def __init__(self, name, device_ms):
        self.name, self.device_ms = name, device_ms


def test_stem_ms_reads_the_device_spans(monkeypatch):
    from desenet_tpu_torch.utils import profiling

    ring = [_Span("forward.stem", 0.5), _Span("forward.stem", 0.75),
            _Span("forward.seg_head", 9.0), _Span("forward.stem", None)]
    monkeypatch.setattr(profiling, "spans", lambda name=None: [
        s for s in ring if name is None or s.name == name])
    assert read("stem_ms.serve", {"calls": 2}) == pytest.approx(0.625)
    assert read("stem_ms.serve", {}) is None
    ring[:] = [_Span("forward.seg_head", 1.0)]
    assert read("stem_ms.serve", {"calls": 2}) is None
