"""The port's spans and counters (``desenet_tpu_torch/utils/profiling.py``)
and the places that record them, on the CPU.

- ``span`` nests by thread, with parent ids and attributes; the ring keeps
  the newest spans and counts what it drops; ``count`` adds host numbers
  and tensors (on their device), ``counters`` reads them, ``reset`` clears.
- Off, ``span`` is one shared null context and ``count`` does nothing: no
  ``record_function``, no span, no counter, and no tensor operation (none
  dispatched, so no launch and no ``.item()``), K1's counting included.
- The profiler's own flag turns tracing on and off, and under a profiler
  each span lies within its ``record_function`` event on the profiler's
  clock (``trace_start_ns`` plus ``time_range``), its ends typically within
  100 us of the event's.
- A tiny ``Predictor`` records ``predict.*`` and ``infer.*`` in order and
  counts K1's candidates as ``nms_planes`` gives them and the results'
  bytes (``download.*``, only while tracing), with one ``predict.download``
  a replica; a tiny train step
  records ``train.*``; ``BatchRunner`` keeps ``runner.queue`` and
  ``runner.request`` with one ``rid`` always, and ``/info`` reports their
  percentiles with the sample count.
- A device span (``span(..., device=<a CUDA device>)``) makes no event
  while tracing is off or for a CPU device, records its pair of events on
  the current stream of the device it is given (not the current
  device's), and reads them into ``device_ms`` once the card has passed
  the second (stand-in events and streams here); the model's
  ``forward.stem``, ``forward.seg_head`` and ``forward.p6`` spans hold no
  device time on the CPU.

On two cards (marked ``cuda``, skipped with fewer): a span given the
second card times the work queued there while the first is current, and
a two-replica ``Predictor`` reads a seg head's device time on each card.
Run on the card:

    python -m pytest --noconftest tests/test_torch_tracing.py -q -k card
"""

import copy
import json
import threading
import time
import urllib.request

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile
from torch.utils._python_dispatch import TorchDispatchMode

from desenet_tpu_torch import serve
from desenet_tpu_torch.api import Predictor
from desenet_tpu_torch.models import build_model, config_path
from desenet_tpu_torch.ops import nms_fused
from desenet_tpu_torch.testing import boosted_state, tiny_cfg, train_batch
from desenet_tpu_torch.train import create_train_state, make_train_step
from desenet_tpu_torch.train.engine import load_hyp, loss_and_schedule
from desenet_tpu_torch.utils import profiling


@pytest.fixture
def tracing():
    """Tracing forced on, from empty rings and counters."""
    profiling.reset()
    profiling.set_tracing(True)
    try:
        yield
    finally:
        profiling.set_tracing(False)
        profiling.reset()


@pytest.fixture
def off():
    profiling.reset()
    profiling.set_tracing(False)
    assert not profiling.tracing()
    yield
    profiling.reset()


class Ops(TorchDispatchMode):
    """The aten operations dispatched inside the block."""

    def __init__(self):
        super().__init__()
        self.ops = []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        self.ops.append(str(func))
        return func(*args, **(kwargs or {}))


def test_spans_nest_with_parents_and_attrs(tracing):
    with profiling.span("a", bid=3) as a:
        with profiling.span("b", n=2, bucket=4) as b:
            pass
        with profiling.span("c") as c:
            seen = {}
            t = threading.Thread(
                target=lambda: seen.update(s=profiling.span("t").__enter__()))
            t.start()
            t.join(10)
            assert not t.is_alive()
    got = {s.name: s for s in profiling.spans()}
    assert [s.name for s in profiling.spans()] == ["b", "c", "a"]  # by end
    assert got["a"].parent is None and got["a"].attrs == {"bid": 3}
    assert got["b"].parent == got["c"].parent == a.id
    assert got["b"].attrs == {"n": 2, "bucket": 4}
    assert len({a.id, b.id, c.id}) == 3
    assert seen["s"].parent is None  # another thread, its own stack
    assert got["a"].start_ns <= got["b"].start_ns <= got["b"].end_ns \
        <= got["c"].start_ns <= got["c"].end_ns <= got["a"].end_ns
    assert profiling.spans("b")[0].id == b.id
    # on the profiler's (epoch) clock, not perf_counter's
    assert abs(got["a"].end_ns - time.time_ns()) < 10e9


def test_ring_drops_the_oldest_and_counts_them():
    ring = profiling.Ring(3)
    for i in range(5):
        ring.add(profiling.Span(f"s{i}", i, i + 1))
    assert [s.name for s in ring.spans()] == ["s2", "s3", "s4"]
    assert ring.dropped() == 2
    ring.clear()
    assert ring.spans() == [] and ring.dropped() == 0


def test_counters_add_host_numbers_and_tensors(tracing):
    profiling.count("n", 2)
    profiling.count("n", 3)
    profiling.count("t", torch.tensor(4))
    profiling.count("t", torch.tensor(5))
    profiling.count("t", 1)
    # the tensors' sum stays a tensor until it is read
    assert any(isinstance(v, torch.Tensor)
               for v in profiling._COUNTERS._sums.values())
    assert profiling.counters() == {"n": 5, "t": 10}
    profiling.reset()
    assert profiling.counters() == {} and profiling.spans() == []


def test_off_records_nothing_and_calls_no_record_function(off, monkeypatch):
    def refuse(*a, **k):
        raise AssertionError("record_function called with tracing off")

    monkeypatch.setattr(profiling, "record_function", refuse)
    monkeypatch.setattr(torch.profiler, "record_function", refuse)
    monkeypatch.setattr(torch.autograd.profiler, "record_function", refuse)
    assert profiling.span("a") is profiling.span("b", n=1)  # one null context
    one = torch.tensor(1)
    with Ops() as mode:
        with profiling.span("a", n=1):
            profiling.count("x", 1)
            profiling.count("y", one)
    assert mode.ops == []
    assert profiling.spans() == [] and profiling.counters() == {}

    # K1's prep with tracing off dispatches exactly the untraced operations
    dec = torch.rand(2, 50, 8) * torch.tensor([64, 64, 16, 16, 1, 1, 1, 1])
    with Ops() as bare:
        planes = nms_fused.nms_planes(dec, 0.25)
        nms_fused.greedy_select(*planes, 10, 0.45)
    with Ops() as counted:
        nms_fused.fused_select_nms(dec, 0.25, 0.45, 10)
    assert counted.ops[:len(bare.ops)] == bare.ops
    with Ops() as traced:
        profiling.set_tracing(True)
        nms_fused.fused_select_nms(dec, 0.25, 0.45, 10)
        profiling.set_tracing(False)
    assert len(traced.ops) > len(counted.ops)  # the count's gt, sum and add


def test_profiler_flag_turns_tracing_on_and_off(off):
    with profiling.span("before"):
        pass
    with profile(activities=[ProfilerActivity.CPU]):
        assert profiling.tracing()
        with profiling.span("during"):
            profiling.count("k", 1)
    assert not profiling.tracing()
    with profiling.span("after"):
        pass
    assert [s.name for s in profiling.spans()] == ["during"]
    assert profiling.counters() == {"k": 1}


def test_spans_share_the_profilers_clock(off):
    # a process's first record_function under a profiler pays for lazy
    # set-up (about a millisecond) inside its event
    with profile(activities=[ProfilerActivity.CPU]):
        with profiling.span("warm"):
            pass
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        for i in range(8):
            with profiling.span(f"clock.{i}"):
                torch.ones(256).sum()
    start = prof.profiler.kineto_results.trace_start_ns()
    events = {e.name: e for e in prof.events() if e.name.startswith("clock.")}
    spans = [s for s in profiling.spans() if s.name.startswith("clock.")]
    assert len(spans) == len(events) == 8
    # a span is stamped inside its event: it lies within the event's
    # bounds, and a preempted stamp only moves it further in, so the
    # typical distance is taken as the median
    gaps = []
    for s in spans:
        tr = events[s.name].time_range
        ev_start, ev_end = start + tr.start * 1e3, start + tr.end * 1e3
        assert ev_start - 100e3 <= s.start_ns <= s.end_ns <= ev_end + 100e3
        gaps += [abs(s.start_ns - ev_start), abs(s.end_ns - ev_end)]
    assert np.median(gaps) < 100e3, gaps


@pytest.fixture(scope="module")
def tiny_predictor():
    cfg = tiny_cfg()
    model, _ = build_model(cfg)
    return Predictor(cfg, boosted_state(model, 0), imgsz=64, conf_thres=1e-3,
                     half=False, device="cpu")


PREDICT = ["predict.call", "predict.letterbox", "predict.stack",
           "predict.run_batch", "predict.pin", "predict.upload",
           "predict.infer", "infer.forward", "forward.stem",
           "forward.seg_head", "infer.nms", "infer.seg_tail",
           "predict.download", "predict.post"]


def test_predictor_spans_in_order_and_k1_count(tracing, tiny_predictor):
    pred = tiny_predictor
    imgs = list(np.random.default_rng(0).integers(0, 256, (2, 64, 64, 3),
                                                  dtype=np.uint8))
    pred(imgs)
    spans = sorted(profiling.spans(), key=lambda s: s.start_ns)
    assert [s.name for s in spans] == PREDICT
    by = {s.name: s for s in spans}
    for name in ("predict.letterbox", "predict.stack", "predict.run_batch",
                 "predict.post"):
        assert by[name].parent == by["predict.call"].id
    for name in ("predict.pin", "predict.upload", "predict.infer",
                 "predict.download"):
        assert by[name].parent == by["predict.run_batch"].id
        assert by[name].attrs == {"replica": 0}
    for name in ("infer.forward", "infer.nms", "infer.seg_tail"):
        assert by[name].parent == by["predict.infer"].id
    assert by["forward.stem"].parent == by["infer.forward"].id
    assert by["forward.seg_head"].parent == by["infer.forward"].id
    assert by["predict.call"].attrs == {"n": 2}

    # K1's counters against nms_planes on the same decode
    batch = np.stack([im[:, :, ::-1] for im in imgs])
    with torch.inference_mode():
        x = torch.from_numpy(batch).permute(0, 3, 1, 2).float() / 255
        (dec, _), _ = pred.model(x)
        score = nms_fused.nms_planes(dec, pred.conf_thres)[4]
    want = int((score > 0).sum())
    assert want > 0
    # the results, 64 px at max_det 300: boxes, scores, classes, num, seg
    out_bytes = 2 * (300 * 4 * 4 + 300 * 4 + 300 * 4 + 4 + 64 * 64)
    # the CPU Predictor runs unfused: the 72 ConvBnAct calls of each of the
    # two eval forwards count plain, and so does each one's stem
    assert profiling.counters() == {"k1.images": 2, "k1.candidates": want,
                                    "download.pinned_bytes": 0,
                                    "download.pageable_bytes": out_bytes,
                                    "epilogue.plain": 2 * 72,
                                    "stem.plain": 2}


def test_run_batch_spans_a_download_a_replica(tracing, tiny_predictor):
    pred = copy.copy(tiny_predictor)
    pred._place_replicas([pred.device] * 2)
    batch = np.random.default_rng(1).integers(0, 256, (3, 64, 64, 3),
                                              dtype=np.uint8)
    pred.run_batch(batch)
    top = profiling.spans("predict.run_batch")
    assert len(top) == 1 and top[0].attrs == {"n": 3}
    under = [s for s in profiling.spans() if s.parent == top[0].id]
    for name in ("predict.pin", "predict.upload", "predict.infer",
                 "predict.download"):
        assert [s.attrs for s in under if s.name == name] == [
            {"replica": 0}, {"replica": 1}]
    assert len(under) == 8


def test_download_counters_only_when_tracing(off, tiny_predictor):
    batch = np.random.default_rng(2).integers(0, 256, (2, 64, 64, 3),
                                              dtype=np.uint8)
    tiny_predictor.run_batch(batch)
    assert profiling.counters() == {}
    profiling.set_tracing(True)
    try:
        got = tiny_predictor.run_batch(batch)
    finally:
        profiling.set_tracing(False)
    c = profiling.counters()
    assert c["download.pinned_bytes"] == 0
    assert c["download.pageable_bytes"] == sum(a.nbytes for a in got)


def test_train_step_spans(tracing):
    cfg = tiny_cfg()
    torch.manual_seed(0)
    model, spec = build_model(cfg, seg_upsample=False, train=True)
    det_loss, opt_cfg, lf = loss_and_schedule(load_hyp(), spec, 64, 3)
    state = create_train_state(model, opt_cfg)
    step = make_train_step(model, det_loss, opt_cfg, lf, nb=4,
                           warmup_iters=4, nominal_bs=2, batch_size=2,
                           fused_seg=True)
    batch = {k: torch.from_numpy(v) for k, v in train_batch(
        np.random.default_rng(0), 2, 64, cfg["de_nc"], 4).items()}
    state, m = step(state, batch)
    assert torch.isfinite(m["loss"]) and m["stepped"] == 1
    spans = sorted(profiling.spans(), key=lambda s: s.start_ns)
    assert [s.name for s in spans] == [
        "train.step", "train.forward", "forward.stem", "forward.seg_head",
        "train.loss", "train.loss.det", "train.loss.seg", "train.backward",
        "train.update", "train.ema"]
    by = {s.name: s for s in spans}
    assert by["forward.stem"].parent == by["train.forward"].id
    assert by["forward.seg_head"].parent == by["train.forward"].id
    for name in ("train.forward", "train.loss", "train.backward",
                 "train.update", "train.ema"):
        assert by[name].parent == by["train.step"].id
    for name in ("train.loss.det", "train.loss.seg"):
        assert by[name].parent == by["train.loss"].id


class _Event:
    """A stand-in for ``torch.cuda.Event`` (no card here): the card passes
    it once ``done`` is set, 2.5 ms after its start's."""

    made = []

    def __init__(self, enable_timing=False):
        assert enable_timing
        self.recorded = False
        self.done = False
        _Event.made.append(self)

    def record(self, stream=None):
        self.recorded = stream

    def query(self):
        return self.done

    def elapsed_time(self, end):
        assert self.recorded and end.recorded and end.done
        return 2.5


def test_device_span_off_creates_no_event(off, monkeypatch):
    _Event.made = []
    monkeypatch.setattr(torch.cuda, "Event", _Event)
    with profiling.span("forward.p6", device=torch.device("cuda", 0)) as s:
        pass
    assert s is None and _Event.made == [] and profiling.spans() == []


def test_device_span_on_a_cpu_device_creates_no_event(tracing, monkeypatch):
    _Event.made = []
    monkeypatch.setattr(torch.cuda, "Event", _Event)
    with profiling.span("forward.p6", device=torch.device("cpu")) as s:
        pass
    assert s.device_ms is None and s._events is None and _Event.made == []


def test_device_span_reads_its_events_once_the_card_has_passed(
        tracing, monkeypatch):
    _Event.made = []
    monkeypatch.setattr(torch.cuda, "Event", _Event)
    # the stream of the device given, whichever device is current
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda device=None: ("stream of", device))
    card = torch.device("cuda", 1)
    with profiling.span("forward.p6", device=card, bid=1):
        with profiling.span("host.only"):
            pass
    start, end = _Event.made
    assert start.recorded == end.recorded == ("stream of", card)
    by = {s.name: s for s in profiling.spans()}
    assert by["forward.p6"].device_ms is None  # the card has not passed
    assert by["forward.p6"].attrs == {"bid": 1}
    end.done = True
    by = {s.name: s for s in profiling.spans()}
    assert by["forward.p6"].device_ms == 2.5
    assert by["host.only"].device_ms is None


def _p6_model():
    cfg = json.load(open(config_path("yolov5x6_seg")))
    cfg.update(width_multiple=0.125)
    torch.manual_seed(0)
    return build_model(cfg)[0]


@pytest.mark.parametrize("model,p6", [
    (lambda: build_model(tiny_cfg())[0], 0), (_p6_model, 2)])
def test_forward_spans_on_the_cpu_hold_no_device_time(tracing, monkeypatch,
                                                      model, p6):
    """The seg head's row and each run of stride-64 rows (rows 9-12 and
    30-32 of a P6 model) are device spans, whose events are made only for
    an input on a card: none on the CPU."""
    net = model()
    _Event.made = []
    monkeypatch.setattr(torch.cuda, "Event", _Event)
    with torch.no_grad():
        net(torch.rand((1, 3, 128, 128)))
    spans = sorted(profiling.spans(), key=lambda s: s.start_ns)
    assert [s.name for s in spans].count("forward.seg_head") == 1
    assert [s.name for s in spans].count("forward.p6") == p6
    assert all(s.device_ms is None for s in spans) and _Event.made == []
    if p6:
        seg = profiling.spans("forward.seg_head")[0]
        first, second = profiling.spans("forward.p6")
        assert first.end_ns <= second.start_ns <= second.end_ns \
            <= seg.start_ns


class _Dets:
    def __init__(self, imgs):
        self.masks = [np.zeros(im.shape[:2], np.uint8) for im in imgs]

    def to_dicts(self):
        return [[] for _ in self.masks]


class _Stub:
    imgsz = 8
    names = ("a",)
    se_names = ("bg",)

    def __call__(self, imgs):
        with profiling.span("predict.call", n=len(imgs)):
            return _Dets(imgs)


def _serve(runner, n):
    reqs = [serve._Pending(np.zeros((8, 8, 3), np.uint8), want_mask=False)
            for _ in range(n)]
    assert all(runner.submit(r) for r in reqs)
    while runner._drain_once():
        pass
    assert all(r.done.is_set() and r.error is None for r in reqs)
    return reqs


def test_batch_runner_keeps_request_and_queue_spans_always(off):
    runner = serve.BatchRunner(_Stub(), max_batch=4, max_wait_ms=1.0)
    reqs = _serve(runner, 3)
    assert len({r.rid for r in reqs}) == 3
    kept = runner.spans.spans()  # one snapshot: one shift of the clock
    req = {s.attrs["rid"]: s for s in kept if s.name == "runner.request"}
    que = {s.attrs["rid"]: s for s in kept if s.name == "runner.queue"}
    assert set(req) == set(que) == {r.rid for r in reqs}
    for rid, q in que.items():
        assert q.parent == req[rid].id and req[rid].parent is None
        assert req[rid].start_ns == q.start_ns <= q.end_ns <= req[rid].end_ns
    lat = runner.latency()
    assert lat["n"] == 3 and set(lat) == {"p50_ms", "p99_ms", "n",
                                          "queue_p50_ms", "queue_p99_ms"}
    assert 0 <= lat["queue_p50_ms"] <= lat["p50_ms"] <= lat["p99_ms"]
    assert profiling.spans() == []  # nothing process-wide with tracing off
    empty = serve.BatchRunner(_Stub(), max_batch=4).latency()
    assert empty == {"p50_ms": None, "p99_ms": None, "n": 0,
                     "queue_p50_ms": None, "queue_p99_ms": None}


def test_batch_runner_spans_when_tracing(tracing):
    runner = serve.BatchRunner(_Stub(), max_batch=4, max_wait_ms=1.0)
    reqs = _serve(runner, 3)
    by = {}
    for s in profiling.spans():
        by.setdefault(s.name, []).append(s)
    assert len(by["runner.request"]) == len(by["runner.queue"]) == 3
    assert {s.attrs["rid"] for s in by["runner.request"]} == \
        {r.rid for r in reqs}
    (batch,) = by["runner.batch"]
    assert batch.attrs == {"bid": 0, "n": 3, "bucket": 4}
    assert by["predict.call"][0].parent == batch.id
    assert by["runner.encode"][0].parent == batch.id


def test_info_reports_latency_with_its_count(off):
    srv = serve.InferenceServer(_Stub(), port=0, max_batch=2)
    srv.start()
    try:
        reqs = [serve._Pending(np.zeros((8, 8, 3), np.uint8), False)
                for _ in range(2)]
        assert all(srv.runner.submit(r) for r in reqs)
        assert all(r.done.wait(30) for r in reqs)
        with urllib.request.urlopen(
                f"http://127.0.0.1:{srv.port}/info", timeout=30) as r:
            info = json.loads(r.read())
    finally:
        srv.stop()
        srv.runner.join(10)
    assert not srv.runner.is_alive()
    lat = info["latency"]
    assert lat["n"] == 2 and lat["p50_ms"] is not None
    assert lat["queue_p50_ms"] is not None and lat["queue_p99_ms"] is not None


# -- two cards -------------------------------------------------------------

def _two_cards():
    if not torch.cuda.is_available() or torch.cuda.device_count() < 2:
        pytest.skip("needs two CUDA devices")
    return torch.device("cuda", 0), torch.device("cuda", 1)


def _busy(dev: torch.device) -> None:
    a = torch.rand((2048, 2048), device=dev)
    for _ in range(50):
        a = a @ a
        a = a / a.norm()


@pytest.mark.cuda
def test_card_device_span_times_the_device_it_is_given(tracing):
    first, second = _two_cards()
    torch.cuda.set_device(first)
    _busy(second)  # warm
    torch.cuda.synchronize(second)
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    start.record(torch.cuda.current_stream(second))
    _busy(second)
    end.record(torch.cuda.current_stream(second))
    torch.cuda.synchronize(second)
    alone = start.elapsed_time(end)
    profiling.reset()
    with profiling.span("forward.seg_head", device=second):
        _busy(second)  # nothing queued on the current (first) card
    torch.cuda.synchronize(second)
    (s,) = profiling.spans("forward.seg_head")
    assert s.device_ms is not None and s.device_ms > 0.5 * alone, \
        (s.device_ms, alone)


@pytest.mark.cuda
def test_card_two_replicas_read_their_seg_head_time(tracing):
    _two_cards()
    cfg = tiny_cfg()
    model, _ = build_model(cfg)
    pred = Predictor(cfg, boosted_state(model, 0), imgsz=64,
                     conf_thres=1e-3, half=True, device="cuda", n_devices=2)
    batch = np.random.default_rng(0).integers(0, 256, (8, 64, 64, 3),
                                              dtype=np.uint8)
    pred.run_batch(batch)  # warm
    profiling.reset()
    pred.run_batch(batch)
    for i in range(2):
        torch.cuda.synchronize(torch.device("cuda", i))
    heads = profiling.spans("forward.seg_head")
    assert len(heads) == 2
    assert all(s.device_ms is not None and s.device_ms > 0 for s in heads)
