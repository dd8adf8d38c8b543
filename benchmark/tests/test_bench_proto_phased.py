"""The reader ``proto_phased_pct.serve`` on synthetic records: the share
of traced forwards whose Proto ran the phase-folded 2x2 conv and the
phase pass (counters ``proto.phased`` and ``proto.plain``). It reads
nothing where the program recorded none (a program without the phase
path), and its manifest entry lists only ``x7seg.serve.b128``."""

import pytest

from benchmark.harness import cell as C

NAME = "proto_phased_pct.serve"


def read(records):
    return C.load_module("metrics", NAME).read(records)


@pytest.fixture
def counting():
    from desenet_tpu_torch.utils import profiling

    profiling.reset()
    profiling.set_tracing(True)
    yield profiling
    profiling.set_tracing(False)
    profiling.reset()


def test_manifest_lists_the_seg_cell_alone():
    entry = next(m for m in C.manifest()["per_layer"] if m["name"] == NAME)
    assert entry["workloads"] == ["x7seg.serve.b128"]
    assert entry["source"] == "program_counter"
    assert entry["moves"] == "serve_img_s"


def test_phased_pct_reads_nothing_without_the_counters(counting):
    counting.count("epilogue.fused", 3)
    assert read({"calls": 2}) is None


def test_phased_pct_reads_the_share_of_phased_protos(counting):
    counting.count("proto.phased", 2)
    assert read({"calls": 2}) == 100.0
    assert read({}) is None  # no traced calls
    counting.count("proto.plain", 2)
    assert read({"calls": 4}) == pytest.approx(50.0)
