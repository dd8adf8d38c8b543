"""BENCHMARK.json against the benchmark's contract, and every cell's
pieces found by name."""

import json
import re
import shutil

import pytest

from benchmark.harness import cell as C

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.\-]{1,16}$")
LINE = re.compile(r"^[^\t\n\r]{1,200}$")
WIDTH = re.compile(r"(_dim|_rank)$|hidden|intermediate|latent|state|"
                   r"projection|head|expansion|width")


@pytest.fixture(scope="module")
def man():
    return C.manifest()


def test_keys_and_shapes(man):
    assert set(man) == {"command", "paths", "run_seconds", "configs",
                        "workloads", "end_to_end", "per_layer"}
    assert man["command"] == ["python3", "benchmark/run.py"]
    assert man["paths"] == ["benchmark"]
    assert isinstance(man["run_seconds"], int) and 1 <= man["run_seconds"] <= 51
    assert 1 <= len(man["configs"]) <= 24 and 1 <= len(man["workloads"]) <= 24
    assert 1 <= len(man["end_to_end"]) <= 16
    assert 1 <= len(man["per_layer"]) <= 128
    assert len(json.dumps(man)) <= 64 * 1024


def test_names_units_and_lines(man):
    entries = (man["configs"] + man["workloads"] + man["end_to_end"]
               + man["per_layer"])
    for e in entries:
        assert NAME.match(e["name"]), e["name"]
    for kind in ("configs", "workloads", "end_to_end", "per_layer"):
        names = [e["name"] for e in man[kind]]
        assert len(names) == len(set(names)), kind
    metrics = [m["name"] for m in man["end_to_end"] + man["per_layer"]]
    assert len(metrics) == len(set(metrics))
    for m in man["end_to_end"] + man["per_layer"]:
        assert UNIT.match(m["unit"]), m
        assert m["better"] in ("lower", "higher")
    for c in man["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert LINE.match(c["source"]) and LINE.match(c["why"])
        assert c["source"].startswith("https://")
        assert c["file"] == f"benchmark/configs/{c['name']}.json"
        assert len(c["reduced"]) <= 16
        assert not any(WIDTH.search(k) for k in c["reduced"])
    for w in man["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert NAME.match(w["config"]) and NAME.match(w["traffic"])
        assert w["chips"] in (1, 4) and LINE.match(w["why"])
    pairs = [(w["config"], w["traffic"]) for w in man["workloads"]]
    assert len(pairs) == len(set(pairs))
    four = sum(w["chips"] == 4 for w in man["workloads"])
    assert four <= max(1, len(man["workloads"]) // 4)


def test_metrics_contract(man):
    e2e = {m["name"]: m for m in man["end_to_end"]}
    assert "setup_s" in e2e and e2e["setup_s"]["bound"] <= 0.25
    cells = {w["name"] for w in man["workloads"]}
    for m in man["end_to_end"]:
        assert set(m) <= {"name", "unit", "better", "bound", "source",
                          "workloads"}
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
        assert set(m.get("workloads", cells)) <= cells
    for m in man["per_layer"]:
        assert set(m) <= {"name", "unit", "better", "source", "layer",
                          "moves", "workloads"}
        assert m["source"] in ("device_trace", "program_span",
                               "program_counter", "host_clock")
        assert m["moves"] in e2e and LINE.match(m["layer"])
        assert set(m.get("workloads", cells)) <= cells
        if "_roofline" in m["name"] or "mfu" in m["name"]:
            assert m["unit"] == "%"
    for w in cells:
        names = {m["name"] for m in C.end_to_end(man, w)}
        assert "setup_s" in names and len(names) >= 2, w
        assert C.per_layer(man, w), w


def test_each_metric_moves_a_metric_its_cells_report(man):
    for m in man["per_layer"]:
        for w in m.get("workloads", []):
            assert m["moves"] in {e["name"] for e in C.end_to_end(man, w)}, \
                (m["name"], w)


def test_every_cell_finds_its_files_by_name(man):
    configs = {c["name"] for c in man["configs"]}
    used = set()
    for w in man["workloads"]:
        wl = C.workload(w["name"])
        for k in ("config", "traffic", "chips", "why"):
            assert wl[k] == w[k], (w["name"], k)
        assert wl["config"] in configs
        used.add(wl["config"])
        conf = C.config(wl["config"])
        assert {"source", "model", "dtype", "imgsz", "init", "assumed",
                "reduced"} <= set(conf)
        drv = C.load_module("drivers", wl["driver"])
        assert callable(drv.run)
        assert wl["limits"] and all(isinstance(v, (int, float))
                                    for v in wl["limits"].values())
    assert used == configs
    for m in man["per_layer"]:
        mod = C.load_module("metrics", m["name"])
        assert (mod.UNIT, mod.MOVES, mod.LAYER) == (m["unit"], m["moves"],
                                                    m["layer"])
        assert mod.read({}) is None  # nothing to read: left out


def test_a_new_cell_and_metric_need_no_edit(tmp_path, monkeypatch):
    """Adding a workload file, a metric file and their manifest entries is
    enough: the harness finds both by name."""
    root = tmp_path / "co"
    shutil.copytree(C.BENCH, root / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__", ".cache"))
    man = C.manifest()
    man["workloads"].append(dict(man["workloads"][0], name="s.serve.b64",
                                 traffic="offline.b64.vga"))
    man["per_layer"].append({"name": "calls.serve", "unit": "calls",
                             "better": "higher", "source": "host_clock",
                             "layer": "host", "moves": "serve_img_s",
                             "workloads": ["s.serve.b64"]})
    (root / "BENCHMARK.json").write_text(json.dumps(man))
    wl = json.loads((root / "benchmark/workloads/s.serve.b128.json")
                    .read_text())
    wl.update(traffic="offline.b64.vga")
    wl["params"]["batch"] = 64
    (root / "benchmark/workloads/s.serve.b64.json").write_text(
        json.dumps(wl))
    (root / "benchmark/metrics/calls.serve.py").write_text(
        'LAYER = "host"\nUNIT = "calls"\nMOVES = "serve_img_s"\n\n\n'
        'def read(rec):\n    return rec.get("calls")\n')
    monkeypatch.setattr(C, "ROOT", root)
    monkeypatch.setattr(C, "BENCH", root / "benchmark")
    m = C.manifest()
    assert C.workload("s.serve.b64")["params"]["batch"] == 64
    assert [x["name"] for x in C.per_layer(m, "s.serve.b64")][-1] == \
        "calls.serve"
    assert C.read_metrics(m, "s.serve.b64", {"calls": 4})["calls.serve"] \
        == {"value": 4.0, "unit": "calls"}


@pytest.mark.parametrize("bad", ["../x", "a/b", ".hidden", ""])
def test_names_cannot_leave_the_benchmark(bad):
    with pytest.raises(ValueError):
        C.workload(bad)
