"""Inference serving: a dynamic micro-batching HTTP server.

The port's own copy of the JAX package's server (``desenet_tpu/serve.py``;
numpy, the standard library and the port's ``utils/profiling``, cv2
imported where a request body or a mask is decoded or encoded). It needs
of its predictor ``__call__``, ``imgsz``, ``names``, ``se_names`` and
``Detections.to_dicts`` (plus ``masks`` for ``?mask=1``), which
``desenet_tpu_torch.api.Predictor`` provides:

    srv = InferenceServer(Predictor("yolov5s_seg", sd), port=0)
    srv.start(); ...; srv.stop()

- **few shapes**: requests are padded to power-of-two batch buckets (1, 2,
  4, ... max_batch), and all images letterbox to the same (imgsz, imgsz), so
  the bucket size is the only shape axis the device program sees.
- **dynamic micro-batching**: concurrent requests are drained into one
  device call (up to ``max_batch``, waiting at most ``max_wait_ms`` for
  stragglers): the card's throughput lives in the batch dimension.
- **one device thread**: a single worker owns all device dispatch; HTTP
  threads only decode and encode bytes.
- **bounded overload behaviour**: the request queue is bounded
  (``max_queue``, default 4x max_batch); when it is full new requests are
  shed at once with 503. Requests that hit the client-side timeout are
  cancelled and skipped at batch assembly, so the device spends no time on
  an answer nobody waits for. Bodies over ``max_body_bytes`` are rejected
  with 413 before being read.

Endpoints:
  GET  /healthz            -> {"ok": true}
  GET  /info               -> model metadata (names, imgsz, buckets, stats,
                              latency)
  POST /predict[?mask=1]   -> body = image bytes (anything cv2.imdecode
                              reads); returns {"detections": [...],
                              "num": n} plus, with mask=1, the class-id
                              segmentation mask as a base64 PNG at native
                              image resolution ("seg_png").

``BatchRunner`` alone (``submit(_Pending(bgr_image, want_mask=False))``)
needs no cv2. Each request has a process-wide id (``_Pending.rid``). The
runner always keeps its last ``RUNNER_SPANS`` spans ``runner.request``
(submit to done) and ``runner.queue`` (submit to the start of its batch),
both with attr ``rid``, in its own ring (``utils/profiling.Ring``):
``latency()``, which is ``/info``'s ``latency``, gives ``p50_ms``,
``p99_ms`` and ``n`` of ``runner.request`` and ``queue_p50_ms``,
``queue_p99_ms`` of ``runner.queue``. With tracing on it also records
them in the process-wide ring, with ``runner.batch`` (attrs ``bid``,
``n``, ``bucket``; the predictor's spans are its children) and
``runner.encode`` (``to_dicts`` and the PNG encodes).

Unlike the original, the runner's stop flag does not shadow
``threading.Thread._stop``, so ``join()`` works after ``stop()``.
"""

from __future__ import annotations

import base64
import itertools
import json
import queue
import threading
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import List, Optional
from urllib.parse import urlparse, parse_qs

import numpy as np

from desenet_tpu_torch.utils import profiling

RUNNER_SPANS = 1024  # runner.request and runner.queue spans a runner keeps
_rids = itertools.count()  # request ids, process-wide


def _bucket(n: int, max_batch: int) -> int:
    """Smallest power of two >= n, capped at max_batch."""
    b = 1 << max(n - 1, 0).bit_length()
    return min(max(b, 1), max_batch)


class _Pending:
    __slots__ = ("img", "want_mask", "done", "result", "error", "cancelled",
                 "rid", "t_submit")

    def __init__(self, img: np.ndarray, want_mask: bool):
        self.img = img
        self.want_mask = want_mask
        self.done = threading.Event()
        self.result: Optional[dict] = None
        self.error: Optional[str] = None
        # set by the HTTP thread when its wait times out: the worker skips
        # cancelled items at batch assembly (no device time for abandoned
        # requests)
        self.cancelled = False
        self.rid = next(_rids)
        self.t_submit = time.perf_counter_ns()


class BatchRunner(threading.Thread):
    """Single device-owning worker: drains the request queue into padded
    micro-batches and runs the Predictor once per batch. ``stop()`` then
    ``join()`` ends it."""

    def __init__(self, predictor, max_batch: int = 16,
                 max_wait_ms: float = 5.0, max_queue: Optional[int] = None):
        super().__init__(daemon=True)
        if max_batch < 1:
            raise ValueError(f"max_batch must be at least 1, got {max_batch}")
        self.predictor = predictor
        self.max_batch = max_batch
        self.max_wait_s = max_wait_ms / 1e3
        # bounded: under sustained overload submit() sheds (503) instead of
        # growing the queue until per-request timeouts fire
        self.max_queue = max_queue if max_queue is not None else 4 * max_batch
        self.queue: "queue.Queue[Optional[_Pending]]" = queue.Queue(
            maxsize=self.max_queue)
        # gray letterbox-native dummy for bucket padding (content is
        # discarded; shape matches every letterboxed request)
        s = predictor.imgsz
        self._pad_img = np.full((s, s, 3), 114, np.uint8)
        self.stats = {"requests": 0, "batches": 0, "max_batch_seen": 0,
                      "padded": 0, "shed": 0, "cancelled": 0}
        # the last runner.request and runner.queue spans, always kept
        self.spans = profiling.Ring(RUNNER_SPANS)
        self._bids = itertools.count()
        self._stopping = False
        # guards the stop-flag check-then-enqueue in submit() vs the drain in
        # stop() (a request admitted between them would strand its HTTP
        # thread for the full timeout), and the stats read-modify-writes
        # (shed from N handler threads vs batch counters from the worker)
        self._lock = threading.Lock()

    def submit(self, pending: _Pending) -> bool:
        """Enqueue a request. Returns False (caller answers 503) when the
        queue is full or the runner is stopping."""
        with self._lock:
            if self._stopping:
                return False
            try:
                self.queue.put_nowait(pending)
                return True
            except queue.Full:
                self.stats["shed"] += 1
                return False

    def stop(self):
        with self._lock:
            self._stopping = True
            # fail everything still queued immediately so HTTP threads
            # don't block out their full request timeout during shutdown
            while True:
                try:
                    item = self.queue.get_nowait()
                except queue.Empty:
                    break
                if item is not None:
                    item.error = "server shutting down"
                    item.done.set()
            try:
                self.queue.put_nowait(None)  # wake a blocked worker
            except queue.Full:
                pass

    def _record(self, s: profiling.Span):
        self.spans.add(s)
        profiling.record(s)

    def latency(self) -> dict:
        """Median and p99 ms of the kept ``runner.request`` spans and their
        count ``n``; the same of ``runner.queue`` as ``queue_p50_ms`` and
        ``queue_p99_ms``. None where there is no span."""
        def pct(ms, q):
            return (round(float(np.percentile(ms, q)), 2) if len(ms)
                    else None)

        req = [s.ms for s in self.spans.spans("runner.request")]
        que = [s.ms for s in self.spans.spans("runner.queue")]
        return {"p50_ms": pct(req, 50), "p99_ms": pct(req, 99), "n": len(req),
                "queue_p50_ms": pct(que, 50), "queue_p99_ms": pct(que, 99)}

    def run(self):
        while not self._stopping:
            try:
                first = self.queue.get(timeout=0.2)
            except queue.Empty:
                continue
            if first is None or first.cancelled:
                if first is not None:
                    self.stats["cancelled"] += 1
                    first.done.set()
                continue
            self._drain_once(first)

    def _drain_once(self, first: Optional[_Pending] = None) -> int:
        """Collect one micro-batch (starting from `first` or the queue) and
        run it. Returns the number of real requests served."""
        batch: List[_Pending] = []
        if first is not None:
            batch.append(first)
        deadline = time.monotonic() + self.max_wait_s
        while len(batch) < self.max_batch:
            remaining = deadline - time.monotonic()
            try:
                if remaining > 0:
                    item = self.queue.get(timeout=remaining)
                else:  # past deadline: take only what is already waiting
                    item = self.queue.get_nowait()
            except queue.Empty:
                break
            if item is None:
                break
            if item.cancelled:  # waiter already gave up: skip, no device time
                self.stats["cancelled"] += 1
                item.done.set()
                continue
            batch.append(item)
        if not batch:
            return 0
        self._run_batch(batch)
        return len(batch)

    def _run_batch(self, batch: List[_Pending]):
        n = len(batch)
        b = _bucket(n, self.max_batch)
        started = time.perf_counter_ns()
        requests = [profiling.Span("runner.request", p.t_submit, rid=p.rid)
                    for p in batch]
        for p, req in zip(batch, requests):
            self._record(profiling.Span("runner.queue", p.t_submit,
                                        started, parent=req.id, rid=p.rid))
        imgs = [p.img for p in batch] + [self._pad_img] * (b - n)
        try:
            with profiling.span("runner.batch", bid=next(self._bids), n=n,
                                bucket=b):
                res = self.predictor(imgs)
                with profiling.span("runner.encode"):
                    self._encode(batch, res)
        except Exception as e:  # batch-wide failure: propagate, keep serving
            for p in batch:
                p.error = f"{type(e).__name__}: {e}"
        finally:
            done = time.perf_counter_ns()
            with self._lock:
                self.stats["requests"] += n
                self.stats["batches"] += 1
                self.stats["max_batch_seen"] = max(
                    self.stats["max_batch_seen"], n)
                self.stats["padded"] += b - n
            for p, req in zip(batch, requests):
                req.end_ns = done
                self._record(req)
                p.done.set()

    def _encode(self, batch: List[_Pending], res):
        dicts = res.to_dicts()
        for i, p in enumerate(batch):
            # per-item post-processing in its own try: one bad mask encode
            # must not 500 its batch-mates (their results are already
            # computed)
            try:
                out = {"detections": dicts[i], "num": len(dicts[i])}
                if p.want_mask:
                    import cv2
                    ok, png = cv2.imencode(".png", res.masks[i])
                    if not ok:
                        raise RuntimeError("mask PNG encode failed")
                    out["seg_png"] = base64.b64encode(
                        png.tobytes()).decode("ascii")
                    out["seg_names"] = list(self.predictor.se_names)
                p.result = out
            except Exception as e:
                p.error = f"{type(e).__name__}: {e}"


class InferenceServer:
    """HTTP front end over a BatchRunner. `port=0` binds an ephemeral port
    (read `self.port` after construction)."""

    def __init__(self, predictor, host: str = "127.0.0.1", port: int = 8000,
                 max_batch: int = 16, max_wait_ms: float = 5.0,
                 request_timeout_s: float = 60.0,
                 max_queue: Optional[int] = None,
                 max_body_bytes: int = 32 * 1024 * 1024):
        self.runner = BatchRunner(predictor, max_batch=max_batch,
                                  max_wait_ms=max_wait_ms,
                                  max_queue=max_queue)
        self.request_timeout_s = request_timeout_s
        self.max_body_bytes = max_body_bytes
        outer = self

        class Handler(BaseHTTPRequestHandler):
            def log_message(self, *a):  # quiet
                pass

            def _json(self, code: int, payload: dict):
                body = json.dumps(payload).encode()
                self.send_response(code)
                self.send_header("Content-Type", "application/json")
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)

            def do_GET(self):
                path = urlparse(self.path).path
                if path == "/healthz":
                    self._json(200, {"ok": True})
                elif path == "/info":
                    p = outer.runner.predictor
                    self._json(200, {
                        "names": list(p.names),
                        "seg_names": list(p.se_names),
                        "imgsz": p.imgsz,
                        "max_batch": outer.runner.max_batch,
                        "max_queue": outer.runner.max_queue,
                        "stats": dict(outer.runner.stats),
                        "latency": outer.runner.latency(),
                    })
                else:
                    self._json(404, {"error": "not found"})

            def do_POST(self):
                parsed = urlparse(self.path)
                if parsed.path != "/predict":
                    self._json(404, {"error": "not found"})
                    return
                want_mask = parse_qs(parsed.query).get(
                    "mask", ["0"])[0] in ("1", "true")
                length = int(self.headers.get("Content-Length", 0))
                if length <= 0:
                    self._json(400, {"error": "empty body"})
                    return
                if length > outer.max_body_bytes:
                    # reject before reading: a huge upload must not be
                    # buffered into memory first
                    self._json(413, {"error": "body too large "
                                     f"(cap {outer.max_body_bytes} bytes)"})
                    return
                raw = self.rfile.read(length)
                import cv2
                img = cv2.imdecode(np.frombuffer(raw, np.uint8),
                                   cv2.IMREAD_COLOR)
                if img is None:
                    self._json(400, {"error": "undecodable image"})
                    return
                pending = _Pending(img, want_mask)
                if not outer.runner.submit(pending):
                    self._json(503, {"error": "overloaded (queue full)"})
                    return
                if not pending.done.wait(outer.request_timeout_s):
                    # mark cancelled so the worker skips it instead of
                    # spending device time on an abandoned request
                    pending.cancelled = True
                    self._json(503, {"error": "inference timeout"})
                    return
                if pending.error is not None:
                    self._json(500, {"error": pending.error})
                else:
                    self._json(200, pending.result)

        self._httpd = ThreadingHTTPServer((host, port), Handler)
        self.host = host
        self.port = self._httpd.server_address[1]
        self._serve_thread: Optional[threading.Thread] = None

    def start(self):
        self.runner.start()
        self._serve_thread = threading.Thread(
            target=self._httpd.serve_forever, daemon=True)
        self._serve_thread.start()

    def stop(self):
        # shutdown() blocks on the serve_forever loop — only call it if one
        # is actually running (stop-before-start must not hang)
        if self._serve_thread is not None:
            self._httpd.shutdown()
        self._httpd.server_close()
        self.runner.stop()
        if self._serve_thread is not None:
            self._serve_thread.join(timeout=5)
            self._serve_thread = None

    def serve_forever(self):
        self.runner.start()
        try:
            self._httpd.serve_forever()
        finally:
            self.runner.stop()
