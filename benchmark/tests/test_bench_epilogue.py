"""``epilogue_fused_pct.serve`` on synthetic counters: the share of the
traced ConvBnAct calls that took the fused epilogue, and nothing where the
program counted none (a program without the fused pass)."""

import pytest

from benchmark.harness import cell as C


def read(records):
    return C.load_module("metrics", "epilogue_fused_pct.serve").read(records)


@pytest.fixture
def counting():
    from desenet_tpu_torch.utils import profiling

    profiling.reset()
    profiling.set_tracing(True)
    yield profiling
    profiling.set_tracing(False)
    profiling.reset()


def test_reads_the_share_of_fused_calls(counting):
    for _ in range(70):
        counting.count("epilogue.fused", 1)
    counting.count("epilogue.plain", 1)
    counting.count("epilogue.plain", 1)
    assert read({"calls": 2}) == pytest.approx(100.0 * 70 / 72)
    assert read({}) is None  # no traced calls
    counting.reset()
    counting.count("epilogue.plain", 3)
    assert read({"calls": 2}) == 0.0


def test_reads_nothing_without_the_counters(counting):
    counting.count("k1.images", 4)
    assert read({"calls": 2}) is None
