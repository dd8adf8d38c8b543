"""The traced run's records: ``torch.profiler`` over a stretch of steady
units inside the window, events kept in memory (no trace file).

``Stretch`` profiles what runs between ``start()`` and ``stop()``;
``records()`` turns the events into plain lists that the per-layer
metrics (``benchmark/metrics/``) read:

- ``device``: (name, start_us, end_us) of every kernel, copy and set on
  the card;
- ``host``: (name, start_us, end_us) of every host op and of the
  benchmark's own labels (``torch.profiler.record_function``);
- ``window_s``: the stretch's length by the host clock;
- ``busy_s``: the time in the stretch in which anything ran on the card
  (the union of the device intervals);
- ``gaps``: the card's idle gaps, each with the innermost host op that
  was running at its middle.
"""

from __future__ import annotations

import time
from typing import List, Optional, Tuple

import torch

_SKIP_LABELS = ("ProfilerStep", "[memory]", "cudaDeviceSynchronize")
LABEL = "bench."  # the benchmark's own host labels (record_function)


def _events(prof) -> Tuple[list, list]:
    from torch.autograd import DeviceType

    device, host = [], []
    for e in prof.events():
        tr = e.time_range
        row = (e.name, float(tr.start), float(tr.end))
        if e.device_type == DeviceType.CUDA:
            # a host label's span mirrored on the device timeline is no work
            if not (getattr(e, "is_user_annotation", False)
                    or e.name.startswith(LABEL)):
                device.append(row)
        elif e.device_type == DeviceType.CPU:
            host.append(row)
    return device, host


def merge(intervals: List[Tuple[float, float]]) -> List[Tuple[float, float]]:
    out: List[List[float]] = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return [(s, e) for s, e in out]


def idle_gaps(device: list, host: list, top: int = 10) -> list:
    """The longest gaps between the card's busy intervals, each
    [innermost host op at its middle, seconds]."""
    busy = merge([(s, e) for _, s, e in device])
    gaps = sorted(((b[0] - a[1], a[1], b[0]) for a, b in zip(busy, busy[1:])
                   if b[0] > a[1]), reverse=True)[:top]
    out = []
    for length, s, e in gaps:
        mid = (s + e) / 2
        around = [(hs, name) for name, hs, he in host
                  if hs <= mid <= he and not name.startswith(_SKIP_LABELS)]
        label = max(around)[1] if around else "(no host op)"
        out.append([label, length / 1e6])
    return out


def top_ops(device: list, top: int = 10) -> list:
    tot = {}
    for name, s, e in device:
        tot[name] = tot.get(name, 0.0) + (e - s) / 1e6
    return [[k, v] for k, v in sorted(tot.items(), key=lambda kv: -kv[1])
            [:top]]


class Stretch:
    """torch.profiler over a stretch of the window, on when ``enabled``."""

    def __init__(self, enabled: bool, device: torch.device):
        self.enabled = enabled
        self.cuda = device.type == "cuda"
        self.prof = None
        self.window_s: Optional[float] = None

    def _sync(self):
        if self.cuda:
            torch.cuda.synchronize()

    def prime(self):
        """One empty profiling session during set-up: the profiler's first
        start is slow (seconds), and the window's must not be."""
        if not self.enabled:
            return
        from torch.profiler import ProfilerActivity, profile

        acts = [ProfilerActivity.CPU] + (
            [ProfilerActivity.CUDA] if self.cuda else [])
        with profile(activities=acts):
            self._sync()

    def start(self):
        if not self.enabled or self.prof is not None:
            return
        from torch.profiler import ProfilerActivity, profile

        acts = [ProfilerActivity.CPU] + (
            [ProfilerActivity.CUDA] if self.cuda else [])
        self._sync()
        self.prof = profile(activities=acts)
        self.prof.__enter__()
        self._t0 = time.perf_counter()

    def stop(self):
        if self.prof is None or self.window_s is not None:
            return
        self._sync()
        self.window_s = time.perf_counter() - self._t0
        self.prof.__exit__(None, None, None)

    def records(self) -> dict:
        if self.prof is None or self.window_s is None:
            return {}
        device, host = _events(self.prof)
        busy = sum(e - s for s, e in merge([(s, e) for _, s, e in device]))
        return {"device": device, "host": host, "window_s": self.window_s,
                "busy_s": busy / 1e6, "gaps": idle_gaps(device, host),
                "top_ops": top_ops(device)}
