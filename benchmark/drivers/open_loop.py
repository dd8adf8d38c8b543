"""Online serving: single camera frames arriving on an open-loop schedule
at ``serve.BatchRunner``, each ``submit(_Pending(frame, want_mask=False))``,
the runner micro-batching them into ``Predictor.__call__`` (letterbox,
stack, ``run_batch``, boxes back on the frame, the mask cropped to it).

Traffic parameters (the workload file's ``params``): ``rate`` in
requests a second, ``pool`` distinct frames of ``frame_hw`` (BGR uint8),
the runner's ``max_batch``, ``max_wait_ms`` and ``max_queue`` (null: its
default), ``sample`` requests compared with the reference (drawn from the
seed), ``drain_s`` the longest wait for answers past the window's close,
and for ``--trace 1`` ``trace_at_s``/``trace_s``, the stretch of the
window under the profiler.

The schedule: ``round(rate * seconds)`` gaps, the exponential
distribution's quantiles at (k + 0.5) / n (so every seed offers the same
gaps, summing to about ``seconds``), in an order drawn from the seed; each
request takes a frame drawn from the seed. A request's latency runs from
when it was due to when the runner set its ``done``; a request the runner
sheds, fails or never answers is failed, and counts in the tail as an
answer ``FAILED_MS`` late.

End-to-end: ``latency_p95_ms`` over all requests of the window;
``setup_s``, process start to the window's start.
"""

from __future__ import annotations

import threading
import time

import numpy as np
import torch
from torch.profiler import record_function

from benchmark.harness.frames import make_frames
from benchmark.harness.trace import Stretch
from benchmark.harness.weights import seeded_weights
from benchmark.reference.serve import judge_frames


FAILED_MS = 1e6  # a failed request's latency: later than any answer


class _Stamped(threading.Event):
    """``_Pending.done`` that notes when it was set."""

    t = None

    def set(self):
        self.t = time.perf_counter()
        super().set()


class _Timed:
    """The predictor the runner is handed: ``Predictor.__call__`` timed
    from the benchmark's side, the start of each call noted for the
    requests in it, the answers to the sampled requests kept."""

    def __init__(self, pred, request_of: dict, sampled: set):
        self.pred = pred
        self.imgsz, self.names, self.se_names = (pred.imgsz, pred.names,
                                                 pred.se_names)
        self.request_of, self.sampled = request_of, sampled
        self.call_start, self.kept, self.prepost_ms = {}, {}, []
        self._in_run_batch = 0.0
        inner = pred.run_batch

        def run_batch(batch):
            t = time.perf_counter()
            try:
                with record_function("bench.run_batch"):
                    return inner(batch)
            finally:
                self._in_run_batch += time.perf_counter() - t

        pred.run_batch = run_batch

    def __call__(self, imgs):
        t0 = time.perf_counter()
        self._in_run_batch = 0.0
        with record_function("bench.predictor_call"):
            res = self.pred(imgs)
        t1 = time.perf_counter()
        self.prepost_ms.append((t1 - t0 - self._in_run_batch) * 1e3)
        for i, im in enumerate(imgs):
            k = self.request_of.get(id(im))
            if k is None:
                continue
            self.call_start[k] = t0
            if k in self.sampled:
                self.kept[k] = (res.xyxy[i], res.masks[i])
        return res


def schedule(rate: float, seconds: float, seed: int, pool: int):
    """(due offsets in seconds, frame index) of every request."""
    n = max(1, int(round(rate * seconds)))
    q = (np.arange(n) + 0.5) / n
    gaps = -np.log1p(-q) / rate
    rng = np.random.default_rng(seed)
    gaps = gaps[rng.permutation(n)]
    due = np.concatenate([[0.0], np.cumsum(gaps)[:-1]])
    return due, rng.integers(0, pool, n)


def offer(runner, frames: np.ndarray, due: np.ndarray, which: np.ndarray,
          request_of: dict, stretch=None, trace_at_s=0.0, trace_s=0.0,
          drain_s: float = 60.0):
    """Submit request k at ``t0 + due[k]`` with frame ``which[k]``; wait for
    the answers (at most ``drain_s`` past the last due time). Returns (t0,
    the pendings, how late each submit ran in seconds)."""
    from desenet_tpu_torch.serve import _Pending

    pend, late = [], np.zeros(len(due))
    t0 = time.perf_counter()
    for k, (d, j) in enumerate(zip(due, which)):
        if stretch is not None:
            if d >= trace_at_s:
                stretch.start()
            if d >= trace_at_s + trace_s:
                stretch.stop()
        wait = t0 + d - time.perf_counter()
        if wait > 0:
            time.sleep(wait)
        late[k] = time.perf_counter() - (t0 + d)
        view = frames[j]
        request_of[id(view)] = k
        p = _Pending(view, want_mask=False)
        p.done = _Stamped()
        p.error = None if runner.submit(p) else "shed"
        pend.append(p)
    if stretch is not None:
        stretch.stop()
    end = t0 + due[-1] + drain_s
    for p in pend:
        if p.error is None:
            p.done.wait(max(0.0, end - time.perf_counter()))
    return t0, pend, late


def latencies_ms(t0: float, due: np.ndarray, pend: list) -> np.ndarray:
    """Per request, due to done in ms; ``FAILED_MS`` for a failed one."""
    out = np.full(len(pend), FAILED_MS)
    for k, p in enumerate(pend):
        if p.error is None and p.done.is_set() and p.done.t is not None:
            out[k] = (p.done.t - (t0 + due[k])) * 1e3
    return out


def setup(ctx: dict):
    """Weights, the Predictor, the frame pool and a started runner, every
    bucket shape warmed, directly and through the runner. Returns (weights, predictor, runner, frames, the
    timed wrapper, the first call's seconds)."""
    from desenet_tpu_torch.api import Predictor
    from desenet_tpu_torch.serve import BatchRunner, _Pending

    tp, conf, dev = ctx["workload"]["params"], ctx["config"], ctx["device"]
    sd = seeded_weights(conf, ctx["seed"], dev)
    pred = Predictor(conf["model"], sd, imgsz=conf["imgsz"],
                     half=conf["dtype"] == "bfloat16", device=dev)
    fh, fw = tp["frame_hw"]
    frames = make_frames(tp["pool"], fh, fw, ctx["seed"] + 2, dev).cpu().numpy()
    t = time.perf_counter()
    pred([frames[0]])
    first_call_s = time.perf_counter() - t
    b = 1
    while b <= tp["max_batch"]:  # the runner's buckets: 1, 2, 4, ...
        for _ in range(2):
            pred([frames[j % tp["pool"]] for j in range(b)])
        b *= 2
    timed = _Timed(pred, {}, set())
    runner = BatchRunner(timed, max_batch=tp["max_batch"],
                         max_wait_ms=tp["max_wait_ms"],
                         max_queue=tp["max_queue"])
    runner.start()
    # the runner's thread makes its own library handles at its first
    # calls: warm it with bursts of every bucket's size, twice
    b = tp["max_batch"]
    for size in [b >> k for k in range(b.bit_length())] * 2:
        burst = [_Pending(frames[j % tp["pool"]], want_mask=False)
                 for j in range(size)]
        for p in burst:
            runner.submit(p)
        for p in burst:
            p.done.wait(60.0)
    return sd, pred, runner, frames, timed, first_call_s


def run(ctx: dict) -> dict:
    tp, conf, dev, seed = (ctx["workload"]["params"], ctx["config"],
                           ctx["device"], ctx["seed"])
    cuda = dev.type == "cuda"
    sd, pred, runner, frames, timed, first_call_s = setup(ctx)
    due, which = schedule(tp["rate"], ctx["seconds"], seed, tp["pool"])
    rng = np.random.default_rng(seed + 3)
    timed.sampled = set(rng.choice(len(due), min(tp["sample"], len(due)),
                                   replace=False).tolist())
    stretch = Stretch(ctx["trace"], dev)
    stretch.prime()
    before = dict(runner.stats)
    if cuda:
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats(dev)  # the window's peak
    setup_s = time.perf_counter() - ctx["t_start"]
    try:
        t0, pend, late = offer(runner, frames, due, which, timed.request_of,
                               stretch if ctx["trace"] else None,
                               tp["trace_at_s"], tp["trace_s"], tp["drain_s"])
    finally:
        runner.stop()
        runner.join(timeout=60)
    lat = latencies_ms(t0, due, pend)
    failed = int(np.sum(lat >= FAILED_MS))
    stats = {k: runner.stats[k] - before.get(k, 0) for k in runner.stats}
    peak = torch.cuda.max_memory_allocated(dev) if cuda else 0
    spec = (pred.conf_thres, pred.iou_thres, pred.max_det)
    del pred, runner
    if cuda:
        torch.cuda.empty_cache()

    ks = sorted(k for k in timed.sampled if k in timed.kept)
    # a shed request is failed, not wrong; any other sampled request must
    # have been answered
    missing = sum(1 for k in timed.sampled
                  if k not in timed.kept and pend[k].error != "shed")
    served = [{"boxes": timed.kept[k][0][:, :4], "scores": timed.kept[k][0][:, 4],
               "classes": timed.kept[k][0][:, 5], "seg": timed.kept[k][1]}
              for k in ks]
    t = time.perf_counter()
    checks, cand = judge_frames(conf, sd, frames[which[ks]], served, dev,
                                *spec)
    ref_s = time.perf_counter() - t
    checks["sample_unanswered"] = float(missing)
    records = stretch.records()
    queue = [(timed.call_start[k] - (t0 + due[k])) * 1e3
             for k in range(len(due)) if k in timed.call_start]
    records.update(runner=stats, queue_ms=queue, prepost_ms=timed.prepost_ms)
    return {
        "e2e": {"latency_p95_ms": float(np.percentile(lat, 95)),
                "setup_s": setup_s},
        "attempted": len(due), "failed": failed,
        "checks": checks, "records": records, "memory_peak_bytes": peak,
        "notes": {"first_call_s": first_call_s, "requests": len(due),
                  "latency_p50_ms": float(np.percentile(lat, 50)),
                  "latency_p99_ms": float(np.percentile(lat, 99)),
                  "generator_late_ms_max": float(late.max() * 1e3),
                  "shed": stats.get("shed", 0),
                  "reference_s": ref_s, "compared_requests": len(ks),
                  "candidates_per_frame_median": float(np.median(cand))
                  if cand else 0.0},
    }
