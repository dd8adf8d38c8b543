"""The sweep that found an open-loop cell's rate: the cell's set-up once,
then its open-loop window at each offered rate in turn.

    python benchmark/sweep_rate.py --workload s.online.vga --seed 5 \\
        --seconds 10 --rates 200,400,600,800

One JSON line a rate: requests, shed, the share answered before the
window closed, p50 and p95 latency (failed requests as ``FAILED_MS``),
and the median latency of the window's last quarter of requests over its
first quarter (above 1 the queue grew). The knee is the highest rate with
nothing shed, at least 99% answered inside the window and no growth; the
cell's ``rate`` is 0.8 of it. The benchmark's own runs never run this.
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--rates", required=True)
    args = ap.parse_args(argv)
    import numpy as np
    import torch

    from benchmark.drivers.open_loop import (latencies_ms, offer, schedule,
                                             setup)
    from benchmark.harness import cell as C

    if not torch.cuda.is_available():
        print("sweep_rate.py: no CUDA card", file=sys.stderr)
        return 2
    wl = C.workload(args.workload)
    ctx = {"workload": wl, "config": C.config(wl["config"]),
           "seed": args.seed, "device": torch.device("cuda", 0)}
    _, _, runner, frames, timed, _ = setup(ctx)
    try:
        for rate in (float(r) for r in args.rates.split(",")):
            due, which = schedule(rate, args.seconds, args.seed,
                                  len(frames))
            before = dict(runner.stats)
            t0, pend, _ = offer(runner, frames, due, which, timed.request_of,
                                drain_s=wl["params"]["drain_s"])
            lat = latencies_ms(t0, due, pend)
            done_in = sum(1 for k, p in enumerate(pend)
                          if p.done.t is not None and p.error is None
                          and p.done.t <= t0 + args.seconds)
            q = max(1, len(lat) // 4)
            print(json.dumps({
                "rate": rate, "requests": len(due),
                "shed": runner.stats["shed"] - before["shed"],
                "answered_in_window": done_in / len(due),
                "p50_ms": float(np.percentile(lat, 50)),
                "p95_ms": float(np.percentile(lat, 95)),
                "growth": float(np.median(lat[-q:]) / np.median(lat[:q])),
                "fill": (runner.stats["requests"] - before["requests"])
                / max(1, runner.stats["batches"] - before["batches"])}),
                flush=True)
            time.sleep(1.0)
    finally:
        runner.stop()
        runner.join(timeout=60)
    return 0


if __name__ == "__main__":
    sys.exit(main())
