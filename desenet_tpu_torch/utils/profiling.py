"""Profiling and model-info utilities.

Counterpart of ``desenet_tpu/utils/profiling.py``: ``Profile`` (wall clock
with a device sync), ``time_fn`` (steady-state seconds a call,
``torch.cuda.synchronize`` where the result lies on a card), ``profile_fn``
(forward and, with ``with_grad``, forward plus backward ms of an op, and
its FLOPs), ``flops_estimate`` (``torch.utils.flop_counter.FlopCounterMode``),
``model_info`` (parameters and GFLOPs at ``img_size``), ``trace``
(``torch.profiler`` into a Chrome trace), ``fold_conv_bn`` (from
``utils/fold.py``), ``sparsity`` and ``prune`` over the conv weights of a
state dict.

FLOPs differ from the JAX package's by design: XLA's cost analysis counts
every elementwise operation of the compiled program, the torch counter
counts the products (convolutions and matmuls, 2 a multiply-add) and
nothing else. The parameter count is the JAX package's: the BNs that never
run and the training-only aux heads, which the JAX variables lack
(``DeSeNet.quirk_bn_keys``, ``train_only_keys``), are not counted.

Spans and counters, the program's own record of where its time and work
go (the port has no JAX counterpart of these):

    with profiling.span("predict.pin", replica=0): ...
    with profiling.span("forward.p6", device=x.device): ...  # card time
    profiling.count("k1.candidates", (score > 0).sum())  # on the device
    profiling.spans(), profiling.counters(), profiling.reset()

Tracing is on while a ``torch.profiler`` session runs (the profiler's own
enabled flag) or after ``set_tracing(True)``, whose default is
``DESENET_TRACE=1`` in the environment at import. Off, ``span`` returns one
shared null context after that one check and ``count`` returns at once:
nothing is recorded, launched, allocated or synchronized, and
``record_function`` is not called. On, each finished span goes to a ring
of ``RING_SPANS`` (the oldest dropped, ``dropped()`` counts them), and
under a profiler it is also a ``record_function`` of its name, so the
profiler's events and its Chrome trace show it. Spans are stamped with
``time.perf_counter_ns()``; ``spans()`` returns them on the profiler's
clock (epoch ns, ``time.time_ns()``: the profiler's events lie at
``kineto_results.trace_start_ns()`` plus their ``time_range`` in us), so a
span of a thread the profiler does not see can be laid against the
device's timeline. A span opened with ``device=`` a CUDA device also
records a pair of timing ``torch.cuda.Event``s on that device's current
stream (not the current device's) at its two ends; its
``device_ms`` is the card's time between them, read by ``spans()`` once
the card has passed the second (the caller synchronizes first), None
before that and for every other span. A counter adds host ints, or 0-d
device tensors on their device (no ``.item()``); ``counters()`` reads
them.
"""

from __future__ import annotations

import contextlib
import itertools
import os
import threading
import time
from collections import deque
from typing import Callable, Dict, List, Mapping, Optional

import numpy as np
import torch
import torch.autograd.profiler as _autograd_profiler
from torch.profiler import record_function

from desenet_tpu_torch.utils.fold import fold_conv_bn  # noqa: F401

RING_SPANS = 65536  # spans the process-wide ring keeps
_tracing = os.environ.get("DESENET_TRACE") == "1"
_NULL = contextlib.nullcontext()
_ids = itertools.count(1)
_local = threading.local()  # .stack: the ids of this thread's open spans


def set_tracing(on: bool) -> None:
    """Record spans and counters with no profiler running too (``on``), or
    only under a profiler (off)."""
    global _tracing
    _tracing = bool(on)


def tracing() -> bool:
    """Whether spans and counters are recorded now."""
    return _tracing or _autograd_profiler._is_profiler_enabled


class Span:
    """A named stretch of work: ``start_ns`` and ``end_ns`` (on
    ``time.perf_counter_ns()`` while recorded, on the profiler's epoch
    clock as ``spans()`` returns them), its ``id``, the ``parent`` span's
    id (None at the top), ``attrs``, a few small ints, and ``device_ms``,
    the card's time between its ends for a device span (module
    docstring), else None."""

    __slots__ = ("name", "start_ns", "end_ns", "id", "parent", "attrs",
                 "device_ms", "_events")

    def __init__(self, name: str, start_ns: int = 0, end_ns: int = 0,
                 parent: Optional[int] = None, **attrs):
        self.name = name
        self.start_ns = start_ns
        self.end_ns = end_ns
        self.id = next(_ids)
        self.parent = parent
        self.attrs = attrs
        self.device_ms: Optional[float] = None
        self._events = None  # (start, end) CUDA events of a device span

    def _resolve(self) -> None:
        """Read the device span's events into ``device_ms`` once the card
        has passed the second."""
        if self._events is not None and self._events[1].query():
            self.device_ms = self._events[0].elapsed_time(self._events[1])
            self._events = None

    @property
    def ms(self) -> float:
        return (self.end_ns - self.start_ns) / 1e6

    def _shifted(self, offset_ns: int) -> "Span":
        out = Span.__new__(Span)
        self._resolve()
        out.name, out.id, out.parent, out.attrs = (
            self.name, self.id, self.parent, self.attrs)
        out.device_ms, out._events = self.device_ms, None
        out.start_ns = self.start_ns + offset_ns
        out.end_ns = self.end_ns + offset_ns
        return out

    def __repr__(self):
        return (f"Span({self.name!r}, {self.ms:.3f} ms, id={self.id}, "
                f"parent={self.parent}, {self.attrs})")


class Ring:
    """Finished spans, at most ``size``, the oldest dropped first."""

    def __init__(self, size: int):
        self._spans: deque = deque(maxlen=size)
        self._dropped = 0
        self._lock = threading.Lock()

    def add(self, span: Span) -> None:
        with self._lock:
            if len(self._spans) == self._spans.maxlen:
                self._dropped += 1
            self._spans.append(span)

    def spans(self, name: Optional[str] = None) -> List[Span]:
        """Copies of the spans (of ``name`` only, if given), oldest first,
        on the profiler's clock: shifted by an anchor pair
        (``perf_counter_ns``, ``time_ns``) taken now."""
        with self._lock:
            snap = list(self._spans)
        offset = time.time_ns() - time.perf_counter_ns()
        return [s._shifted(offset) for s in snap
                if name is None or s.name == name]

    def dropped(self) -> int:
        return self._dropped

    def clear(self) -> None:
        with self._lock:
            self._spans.clear()
            self._dropped = 0


class _Counters:
    """Named sums: host numbers, and 0-d tensors added on their device."""

    def __init__(self):
        self._sums: Dict[tuple, object] = {}
        self._lock = threading.Lock()

    def add(self, name: str, value) -> None:
        key = name
        if isinstance(value, torch.Tensor):
            value = value.detach()
            key = (name, value.device)
        with self._lock:
            self._sums[key] = self._sums.get(key, 0) + value

    def read(self) -> Dict[str, float]:
        with self._lock:
            sums = dict(self._sums)
        out: Dict[str, float] = {}
        for key, v in sums.items():
            name = key[0] if isinstance(key, tuple) else key
            out[name] = out.get(name, 0) + (
                v.item() if isinstance(v, torch.Tensor) else v)
        return out

    def clear(self) -> None:
        with self._lock:
            self._sums.clear()


_RING = Ring(RING_SPANS)
_COUNTERS = _Counters()


class _Open:
    """An open span: on the thread's stack, and under a profiler also a
    ``record_function`` of its name."""

    __slots__ = ("span", "_rf", "_stream")

    def __init__(self, span: Span, stream=None):
        self.span = span
        self._rf = None
        self._stream = stream  # a device span's CUDA stream

    def __enter__(self) -> Span:
        stack = getattr(_local, "stack", None)
        if stack is None:
            stack = _local.stack = []
        s = self.span
        s.parent = stack[-1] if stack else None
        stack.append(s.id)
        if _autograd_profiler._is_profiler_enabled:
            self._rf = record_function(s.name).__enter__()
        # stamped inside the record_function's event, whose first opening in
        # a profiling session spends long before the event's own stamp
        s.start_ns = time.perf_counter_ns()
        if self._stream is not None:
            s._events = (torch.cuda.Event(enable_timing=True),
                         torch.cuda.Event(enable_timing=True))
            s._events[0].record(self._stream)
        return s

    def __exit__(self, *exc):
        s = self.span
        if s._events is not None:
            s._events[1].record(self._stream)
        s.end_ns = time.perf_counter_ns()
        if self._rf is not None:
            self._rf.__exit__(*exc)
        _local.stack.pop()
        _RING.add(s)
        return False


def span(name: str, device: Optional[torch.device] = None, **attrs):
    """``with span(name, **attrs):`` records the block as a ``Span`` whose
    parent is the thread's innermost open span, when tracing is on; the
    shared null context when it is off. ``device``, a CUDA device (the
    block's work queued on that device's current stream), also times the
    block on the card: ``Span.device_ms``; any other device, or None, does
    not."""
    if not (_tracing or _autograd_profiler._is_profiler_enabled):
        return _NULL
    stream = (torch.cuda.current_stream(device)
              if device is not None and device.type == "cuda" else None)
    return _Open(Span(name, **attrs), stream)


def record(span: Span) -> None:
    """Add a span timed by its caller (``perf_counter_ns`` stamps) to the
    ring, when tracing is on: a stretch that starts on one thread and ends
    on another."""
    if _tracing or _autograd_profiler._is_profiler_enabled:
        _RING.add(span)


def count(name: str, value) -> None:
    """Add ``value`` (a host number or a 0-d tensor, added on its device)
    to the counter ``name``, when tracing is on."""
    if _tracing or _autograd_profiler._is_profiler_enabled:
        _COUNTERS.add(name, value)


def spans(name: Optional[str] = None) -> List[Span]:
    """The ring's spans (of ``name`` only, if given) on the profiler's
    clock, oldest first."""
    return _RING.spans(name)


def dropped() -> int:
    """Spans the ring has dropped since the last ``reset()``."""
    return _RING.dropped()


def counters() -> Dict[str, float]:
    """Each counter's sum (device sums read back: this waits for them)."""
    return _COUNTERS.read()


def reset() -> None:
    """Clear the spans and the counters."""
    _RING.clear()
    _COUNTERS.clear()


def _cuda_devices(out) -> set:
    """The CUDA devices of the tensors in ``out`` (nested lists, tuples and
    dicts)."""
    if isinstance(out, torch.Tensor):
        return {out.device} if out.is_cuda else set()
    if isinstance(out, (list, tuple)):
        return set().union(*(_cuda_devices(v) for v in out)) if out else set()
    if isinstance(out, dict):
        return _cuda_devices(list(out.values()))
    return set()


def _sync(out) -> None:
    for dev in _cuda_devices(out):
        torch.cuda.synchronize(dev)


class Profile(contextlib.ContextDecorator):
    """``with Profile():`` or ``@Profile()``: wall-clock seconds in ``.t``,
    printed; the current card (where CUDA is initialized) is synchronized
    at both ends."""

    def __init__(self, name: str = ""):
        self.name = name
        self.t = 0.0

    @staticmethod
    def _sync_current():
        if torch.cuda.is_available() and torch.cuda.is_initialized():
            torch.cuda.synchronize()

    def __enter__(self):
        self._sync_current()
        self.start = time.perf_counter()
        return self

    def __exit__(self, *exc):
        self._sync_current()
        self.t = time.perf_counter() - self.start
        print(f"{self.name or 'profile'}: {self.t:.4f}s")
        return False


def time_fn(fn: Callable, *args, iters: int = 10, warmup: int = 2) -> float:
    """Steady-state seconds a call of ``fn(*args)``, the result's cards
    synchronized after the warm-up and after the timed calls."""
    for _ in range(warmup):
        _sync(fn(*args))
    t0 = time.perf_counter()
    for _ in range(iters):
        out = fn(*args)
    _sync(out)
    return (time.perf_counter() - t0) / iters


def profile_fn(fn: Callable, *args, iters: int = 10,
               with_grad: bool = False) -> Dict[str, float]:
    """``{"forward_ms", "gflops"}`` of ``fn(*args)`` (forward without
    autograd), and with ``with_grad`` ``"backward_ms"``: the forward and
    the backward of the sum of the output in f32, as ``jax.grad`` times
    them, into every tensor that requires a gradient (a module's
    parameters; floating-point tensor arguments are made to)."""
    with torch.no_grad():
        fwd = time_fn(fn, *args, iters=iters)
    out = {"forward_ms": fwd * 1e3, "gflops": flops_estimate(fn, *args) / 1e9}
    if with_grad:
        gargs = [a.detach().requires_grad_(True)
                 if isinstance(a, torch.Tensor) and a.is_floating_point()
                 else a for a in args]

        def fwd_bwd(*a):
            y = fn(*a)
            y = y if isinstance(y, torch.Tensor) else torch.cat(
                [v.flatten() for v in y])
            y.float().sum().backward()
            return y

        out["backward_ms"] = time_fn(fwd_bwd, *gargs, iters=iters) * 1e3
    return out


def flops_estimate(fn: Callable, *args) -> float:
    """FLOPs of one ``fn(*args)`` by ``FlopCounterMode``: convolutions and
    matmuls at 2 a multiply-add."""
    from torch.utils.flop_counter import FlopCounterMode

    counter = FlopCounterMode(display=False)
    with torch.no_grad(), counter:
        fn(*args)
    return float(counter.get_total_flops())


def count_params(model) -> int:
    """The parameters of ``model`` that the JAX package's variables hold:
    all, less the never-run BNs and the training-only modules."""
    skip = set(model.quirk_bn_keys()) | set(model.train_only_keys())
    return sum(p.numel() for k, p in model.named_parameters() if k not in skip)


def model_info(model, img_size: int = 640) -> Dict[str, float]:
    """Parameters and eval-forward GFLOPs of a ``DeSeNet`` at one image of
    ``img_size``, on the model's device and in its dtype; printed as a
    banner."""
    p = next(model.parameters())
    x = torch.zeros((1, model.spec.ch_in, img_size, img_size),
                    dtype=p.dtype, device=p.device)
    was = model.training
    model.eval()
    try:
        gflops = flops_estimate(model, x) / 1e9
    finally:
        model.train(was)
    n_params = count_params(model)
    print(f"model: {n_params / 1e6:.2f}M params, {gflops:.1f} GFLOPs "
          f"@ {img_size}px")
    return {"params": n_params, "gflops": gflops}


@contextlib.contextmanager
def trace(log_dir: str = "runs/trace"):
    """``torch.profiler`` over the block (the CPU, and the cards where CUDA
    is available), written to ``log_dir/trace.json`` as a Chrome trace
    (chrome://tracing, Perfetto), the program's spans among the host's
    events; yields the profiler."""
    from torch.profiler import ProfilerActivity, profile

    acts = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with profile(activities=acts) as prof:
        yield prof
    prof.export_chrome_trace(os.path.join(log_dir, "trace.json"))


def _conv_weights(sd: Mapping[str, torch.Tensor]):
    return [k for k, v in sd.items() if k.endswith("weight") and v.dim() == 4]


def sparsity(sd: Mapping[str, torch.Tensor]) -> float:
    """Global fraction of zero entries over the tensors of ``sd`` (a state
    dict or ``dict(model.named_parameters())``)."""
    total = zeros = 0
    for v in sd.values():
        total += v.numel()
        zeros += int((v == 0).sum())
    return zeros / max(total, 1)


def prune(sd: Mapping[str, torch.Tensor], amount: float = 0.3
          ) -> Dict[str, torch.Tensor]:
    """L1 unstructured pruning of each conv weight of ``sd``: the entries
    below the magnitude of the ``int(numel * amount)``-th smallest (0-based)
    become zero. Returns a new dict; other entries pass through."""
    out = dict(sd)
    for k in _conv_weights(sd):
        w = sd[k]
        n = int(w.numel() * amount)
        if n == 0:
            continue
        a = w.detach().abs()
        thresh = np.partition(a.flatten().cpu().numpy(), n)[n]
        out[k] = torch.where(a < torch.as_tensor(thresh, dtype=w.dtype,
                                                 device=w.device),
                             torch.zeros_like(w), w)
    return out
