"""The readers of the program's spans and counters
(``benchmark/metrics/`` with source ``program_span`` or
``program_counter``) on synthetic records: each reads its number, and
returns None where its spans or counters are absent, as on a program that
records none."""

import pytest

from benchmark.harness import cell as C
from benchmark.harness.spans import overlap

# two traced calls; times in us on the profiler's clock, window 0..1000
DEVICE = [("kernel", 100.0, 300.0), ("Memcpy_HtoD", 500.0, 600.0),
          ("kernel", 650.0, 700.0)]
HOST = [("predict.pin", 0.0, 100.0), ("aten::pin_memory", 10.0, 90.0),
        ("predict.infer", 100.0, 130.0), ("predict.download", 130.0, 350.0),
        ("predict.pin", 400.0, 450.0), ("predict.infer", 500.0, 520.0),
        ("predict.download", 520.0, 800.0)]
TRAIN = [("train.step", 0.0, 900.0), ("train.loss", 300.0, 400.0),
         ("train.loss.det", 300.0, 350.0), ("train.update", 600.0, 660.0),
         ("train.ema", 660.0, 720.0)]


def rec(host, calls=2):
    return {"device": DEVICE, "host": host, "window_s": 1000e-6,
            "calls": calls}


def read(name, records):
    return C.load_module("metrics", name).read(records)


@pytest.mark.parametrize("name,want", [
    ("pin_ms.serve", (100 + 50) / 1e3 / 2),
    ("enqueue_ms.serve", (30 + 20) / 1e3 / 2),
    ("download_ms.serve", (220 + 280) / 1e3 / 2),
    # pin or download: 650 us, of which the card is busy 170 (130..300),
    # 80 (520..600) and 50 (650..700)
    ("idle_copy_pct.serve", 100.0 * (650 - 300) / 1000),
])
def test_serve_span_readers(name, want):
    assert read(name, rec(HOST)) == pytest.approx(want)


@pytest.mark.parametrize("name,want", [
    ("step_host_ms.train", 900 / 1e3 / 2),
    ("idle_loss_pct.train", 100.0 * 100 / 1000),  # 300..400, the card idle
    # update then EMA, 600..720, the card busy 650..700
    ("idle_update_pct.train", 100.0 * (120 - 50) / 1000),
])
def test_train_span_readers(name, want):
    assert read(name, rec(TRAIN)) == pytest.approx(want)


SPAN_METRICS = ["pin_ms.serve", "enqueue_ms.serve", "download_ms.serve",
                "idle_copy_pct.serve", "step_host_ms.train",
                "idle_loss_pct.train", "idle_update_pct.train"]


@pytest.mark.parametrize("name", SPAN_METRICS)
def test_span_readers_find_nothing_without_spans(name):
    bare = [("aten::copy_", 0.0, 100.0), ("bench.run_batch", 0.0, 900.0)]
    assert read(name, rec(bare)) is None
    assert read(name, {}) is None


@pytest.mark.parametrize("name", ["idle_copy_pct.serve",
                                  "idle_loss_pct.train"])
def test_idle_readers_need_the_device(name):
    r = rec(HOST + TRAIN)
    r["device"] = []
    assert read(name, r) is None


def test_k1_candidates_reads_the_programs_counters():
    from desenet_tpu_torch.utils import profiling

    profiling.reset()
    profiling.set_tracing(True)
    try:
        profiling.count("k1.images", 4)
        profiling.count("k1.candidates", 300)
        # counters from earlier work: nothing without traced calls
        assert read("k1_candidates.serve", {}) is None
        assert read("k1_candidates.serve", {"device": DEVICE}) is None
        assert read("k1_candidates.serve", rec(HOST)) == 75.0
        profiling.reset()
        assert read("k1_candidates.serve", rec(HOST)) is None  # no images
    finally:
        profiling.set_tracing(False)
        profiling.reset()


def test_overlap_of_interval_lists():
    assert overlap([(0, 10), (20, 30)], [(5, 25)]) == 10
    assert overlap([(0, 10)], [(10, 20)]) == 0
    assert overlap([], [(0, 1)]) == 0
