"""Finding a cell's pieces by name: its workload file, configuration,
driver and per-layer metrics. Nothing here names a cell: a later cell,
configuration or metric is a new file and a new entry in
``BENCHMARK.json``, and needs no edit of this file.

- ``BENCHMARK.json`` at the root of the checkout: the manifest;
- ``benchmark/workloads/<cell>.json``: config, traffic name, driver, the
  traffic's parameters, chips, why, and the limits of the comparison;
- ``benchmark/configs/<config>.json``: the model, its dtype, the weight
  recipe, ``assumed`` and ``reduced``;
- ``benchmark/drivers/<driver>.py``: ``run(ctx) -> Outcome``;
- ``benchmark/metrics/<metric>.py``: ``LAYER``, ``UNIT``, ``MOVES`` and
  ``read(records) -> float or None``.
"""

from __future__ import annotations

import importlib.util
import json
import re
from pathlib import Path
from types import ModuleType
from typing import Dict, List

ROOT = Path(__file__).resolve().parents[2]
BENCH = ROOT / "benchmark"
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")


def _name(name: str) -> str:
    if not NAME.match(name) or ".." in name:
        raise ValueError(f"not a benchmark name: {name!r}")
    return name


def manifest() -> dict:
    with open(ROOT / "BENCHMARK.json") as f:
        return json.load(f)


def workload(name: str) -> dict:
    with open(BENCH / "workloads" / f"{_name(name)}.json") as f:
        return json.load(f)


def config(name: str) -> dict:
    with open(BENCH / "configs" / f"{_name(name)}.json") as f:
        return json.load(f)


def load_module(kind: str, name: str) -> ModuleType:
    """``benchmark/<kind>/<name>.py`` as a module (names may hold dots)."""
    path = BENCH / kind / f"{_name(name)}.py"
    spec = importlib.util.spec_from_file_location(
        f"benchmark.{kind}._{name.replace('.', '_').replace('-', '_')}",
        path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _applies(entry: dict, cell: str) -> bool:
    return cell in entry["workloads"] if "workloads" in entry else True


def end_to_end(man: dict, cell: str) -> List[dict]:
    """The end-to-end metrics the cell reports (every one without a
    ``workloads`` key, and those that list it)."""
    return [m for m in man["end_to_end"] if _applies(m, cell)]


def per_layer(man: dict, cell: str) -> List[dict]:
    """The per-layer metrics the cell reports: those that list it, and
    those without a ``workloads`` key whose ``moves`` the cell reports."""
    e2e = {m["name"] for m in end_to_end(man, cell)}
    return [m for m in man["per_layer"]
            if (cell in m["workloads"] if "workloads" in m
                else m["moves"] in e2e)]


def read_metrics(man: dict, cell: str, records: dict) -> Dict[str, dict]:
    """Each per-layer metric's reader over the traced run's records; a
    reader that finds nothing to read returns None and is left out."""
    out = {}
    for m in per_layer(man, cell):
        v = load_module("metrics", m["name"]).read(records)
        if v is not None:
            out[m["name"]] = {"value": float(v), "unit": m["unit"]}
    return out
