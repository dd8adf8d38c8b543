"""One run of one cell of the benchmark of ``desenet_tpu_torch`` on NVIDIA
cards.

    python benchmark/run.py --workload s.serve.b128 --seed 7 --seconds 20 \\
        --trace 0

Reads the cell from ``BENCHMARK.json`` and ``benchmark/workloads/<cell>.json``
(``harness/cell.py``), makes the weights and the traffic from ``--seed`` on
the card, warms up the cell's shapes, measures for ``--seconds`` (with
``--trace 1`` a stretch of the window under ``torch.profiler`` and the
per-layer metrics in place of the end-to-end ones), then holds what the
timed path served against the plain reference. Standard error ends with
each number compared beside its limit; standard output ends with one JSON
line: ``correct``, ``attempted``, ``failed``, ``metrics``, ``device``,
with ``--trace 1`` ``breakdown``, and last ``checks``.

Without a CUDA card, or with fewer than the cell asks for, it exits 2 and
prints no result. It exits 3 and prints no result if JAX, flax or the JAX
package is loaded once the window has closed.
"""

from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
# kernel caches at fixed paths inside the checkout (the program's own nvcc
# build lives in desenet_tpu_torch/_build/ there)
for var, sub in (("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                 ("TRITON_CACHE_DIR", "triton")):
    os.environ[var] = str(ROOT / "benchmark" / ".cache" / sub)
os.environ["USE_FLAX"] = "0"

FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "orbax", "desenet_tpu")


def loaded_forbidden() -> list:
    """Top-level names of loaded modules that the port must not pull in,
    compared whole (``desenet_tpu_torch`` is not ``desenet_tpu``)."""
    tops = {name.split(".", 1)[0] for name in list(sys.modules)}
    return sorted(tops & set(FORBIDDEN))


def execute(cell_name: str, seed: int, seconds: float, trace: bool,
            device, t_start: float) -> dict:
    """The run without the look for a card: the driver's set-up, window
    and comparison, and the result dict."""
    from benchmark.harness import cell as C

    man = C.manifest()
    wl = C.workload(cell_name)
    conf = C.config(wl["config"])
    drv = C.load_module("drivers", wl["driver"])
    ctx = {"cell": cell_name, "workload": wl, "config": conf, "seed": seed,
           "seconds": seconds, "trace": trace, "device": device,
           "t_start": t_start}
    out = drv.run(ctx)
    e2e = {m["name"]: m["unit"] for m in C.end_to_end(man, cell_name)}
    if trace:
        metrics = C.read_metrics(man, cell_name, out["records"])
    else:
        metrics = {k: {"value": float(out["e2e"][k]), "unit": u}
                   for k, u in e2e.items()}
    checks = {k: {"value": float(v), "limit": float(wl["limits"][k])}
              for k, v in out["checks"].items()}
    correct = bool(checks) and all(c["value"] <= c["limit"]
                                   for c in checks.values())
    import torch

    dev = {"platform": "gpu" if device.type == "cuda" else device.type,
           "kind": (torch.cuda.get_device_name(device)
                    if device.type == "cuda" else "cpu"),
           "count": int(wl["chips"]),
           "memory_peak_bytes": int(out["memory_peak_bytes"])}
    result = {"correct": correct, "attempted": int(out["attempted"]),
              "failed": int(out["failed"]), "metrics": metrics,
              "device": dev}
    rec = out.get("records") or {}
    if trace and rec.get("window_s"):
        dev["busy_s"] = min(rec["busy_s"], rec["window_s"])
        dev["window_s"] = rec["window_s"]
        result["breakdown"] = {"device_ops": rec["top_ops"],
                               "idle_gaps": rec["gaps"]}
    result["notes"] = out.get("notes", {})
    result["checks"] = checks
    return result


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    from benchmark.harness import cell as C

    wl = C.workload(args.workload)
    import torch

    if not torch.cuda.is_available() or \
            torch.cuda.device_count() < int(wl["chips"]):
        print(f"run.py: {args.workload} needs {wl['chips']} CUDA card(s); "
              f"found {torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 2
    res = execute(args.workload, args.seed, args.seconds, bool(args.trace),
                  torch.device("cuda", 0), T_START)
    bad = loaded_forbidden()
    if bad:
        print(f"run.py: loaded in this process: {', '.join(bad)}",
              file=sys.stderr)
        return 3
    for k, v in res.pop("notes").items():
        print(f"{k}: {v}", file=sys.stderr)
    for k, c in res["checks"].items():
        ok = "ok" if c["value"] <= c["limit"] else "FAIL"
        print(f"check {k} {c['value']!r} limit {c['limit']!r} {ok}",
              file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(res), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
