"""Offline W&B backend (an API-compatible subset of ``wandb``), the port's
copy of ``desenet_tpu/utils/wandb_offline.py``.

The ``wandb`` package is not installed, and the machines have no network.
This module provides the subset of wandb's public API that
``utils/wandb_logger.py`` needs (runs, ``log``, media Tables and Images,
artifacts with aliases, artifact lookup), persisting everything to a local
run directory in the JAX package's layout, so that either package reads a
run that the other wrote. When the real ``wandb`` package is importable the
logger uses it instead (same call signatures).

On-disk layout (under ``dir``, else WANDB_DIR, else ./wandb):
  offline-run-<id>/
    config.json        run config
    summary.json       latest value of every logged key
    history.jsonl      one JSON object per log() commit (media by reference)
    files/             media payloads (images as .npy + meta)
    artifacts/<name>/v<k>/...   artifact file trees
    artifacts/<name>/v<k>.manifest.json   {type, metadata, aliases, files}

Media and run ids draw on ``secrets``, not on numpy's global generator,
so logging leaves a seeded run's random draws as they were.
``Run.use_artifact`` stands in for the server: it looks in the offline runs
beside this one and, where WANDB_DIR is set, in those under it, so a run
written under its run directory finds the dataset artifacts that
``cli/log_dataset.py`` logged under WANDB_DIR. ``latest`` is the highest
version (the JAX package's copy sorts the names, so v10 comes before v9).
"""

from __future__ import annotations

import glob
import json
import os
import secrets
import shutil
import time
from typing import Any, Dict, List, Optional, Sequence

import numpy as np

run = None  # module-level current run, like wandb.run


class Table:
    """wandb.Table: columns + row data; media cells serialize by reference."""

    def __init__(self, columns: Sequence[str], data: Optional[List] = None):
        self.columns = list(columns)
        self.data = [list(r) for r in (data or [])]

    def add_data(self, *row):
        assert len(row) == len(self.columns), (row, self.columns)
        self.data.append(list(row))

    def _serialize(self, run_dir: str):
        rows = []
        for r in self.data:
            rows.append([
                c._serialize(run_dir) if isinstance(c, Image) else c
                for c in r
            ])
        return {"_type": "table", "columns": self.columns, "data": rows}


class Image:
    """wandb.Image: array/path + boxes/masks overlays (box_data schema)."""

    def __init__(self, data: Any, boxes: Optional[Dict] = None,
                 masks: Optional[Dict] = None, caption: str = ""):
        self.data = data
        self.boxes = boxes
        self.masks = masks
        self.caption = caption

    def _serialize(self, run_dir: str):
        files = os.path.join(run_dir, "files")
        os.makedirs(files, exist_ok=True)
        ref = f"media_{int(time.time()*1e6)}_{secrets.randbelow(1 << 30)}"
        out = {"_type": "image", "caption": self.caption}
        if isinstance(self.data, str):
            out["path"] = self.data
        else:
            arr = np.asarray(self.data)
            np.save(os.path.join(files, ref + ".npy"), arr)
            out["path"] = os.path.join("files", ref + ".npy")
            out["shape"] = list(arr.shape)
        if self.boxes is not None:
            out["boxes"] = _jsonable(self.boxes)
        if self.masks is not None:
            masks = {}
            for key, m in self.masks.items():
                m = dict(m)
                md = np.asarray(m.pop("mask_data"))
                np.save(os.path.join(files, f"{ref}_{key}_mask.npy"), md)
                m["mask_path"] = os.path.join("files", f"{ref}_{key}_mask.npy")
                masks[key] = _jsonable(m)
            out["masks"] = masks
        return out


def _jsonable(obj):
    if isinstance(obj, dict):
        return {str(k): _jsonable(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return [_jsonable(v) for v in obj]
    if isinstance(obj, (np.integer,)):
        return int(obj)
    if isinstance(obj, (np.floating,)):
        return float(obj)
    if isinstance(obj, np.ndarray):
        return obj.tolist()
    return obj


class Artifact:
    def __init__(self, name: str, type: str = "dataset",
                 metadata: Optional[Dict] = None):
        self.name = name
        self.type = type
        self.metadata = metadata or {}
        self._files: List = []   # (src_path, dest_name)
        self._objs: List = []    # (Table, dest_name)
        self._dir: Optional[str] = None  # set once logged/downloaded

    def add_file(self, path: str, name: Optional[str] = None):
        self._files.append((path, name or os.path.basename(path)))

    def add_dir(self, path: str, name: str = ""):
        for f in sorted(glob.glob(os.path.join(path, "**", "*"),
                                  recursive=True)):
            if os.path.isfile(f):
                rel = os.path.relpath(f, path)
                self._files.append((f, os.path.join(name, rel) if name
                                    else rel))

    def add(self, obj: Table, name: str):
        self._objs.append((obj, name))

    # -- read side (after download/use_artifact) --
    def download(self) -> str:
        assert self._dir, "artifact not materialized"
        return self._dir

    def get_path(self, name: str):
        d = self._dir

        class _P:
            @staticmethod
            def download():
                return os.path.join(d, name)
        return _P()

    def get(self, name: str):
        with open(os.path.join(self._dir, name + ".table.json")) as f:
            t = json.load(f)
        return Table(t["columns"], t["data"])

    def wait(self):
        return self


def _version(manifest_path: str) -> int:
    """k of ``.../v<k>.manifest.json``."""
    return int(os.path.basename(manifest_path)[1:-len(".manifest.json")])


class Run:
    def __init__(self, root: str, project: str, run_id: str, name: str,
                 config: Dict, job_type: str):
        self.id = run_id
        self.name = name or run_id
        self.project = project
        self.job_type = job_type
        self.dir = os.path.join(root, f"offline-run-{run_id}")
        os.makedirs(os.path.join(self.dir, "files"), exist_ok=True)
        self.config = dict(config or {})
        self.summary: Dict[str, Any] = {}
        self._step = 0
        self._flush_config()

    def _flush_config(self):
        with open(os.path.join(self.dir, "config.json"), "w") as f:
            json.dump(_jsonable(self.config), f, indent=1)

    def log(self, metrics: Dict, step: Optional[int] = None,
            commit: bool = True):
        row: Dict[str, Any] = {"_step": self._step if step is None else step}
        for k, v in metrics.items():
            if isinstance(v, Table):
                row[k] = v._serialize(self.dir)
            elif isinstance(v, Image):
                row[k] = v._serialize(self.dir)
            elif isinstance(v, (list, tuple)) and v and isinstance(v[0], Image):
                row[k] = [im._serialize(self.dir) for im in v]
            else:
                row[k] = _jsonable(v)
        with open(os.path.join(self.dir, "history.jsonl"), "a") as f:
            f.write(json.dumps(row) + "\n")
        self.summary.update(row)
        with open(os.path.join(self.dir, "summary.json"), "w") as f:
            json.dump(self.summary, f, indent=1)
        self._step += 1

    def log_artifact(self, artifact: Artifact,
                     aliases: Optional[List[str]] = None):
        base = os.path.join(self.dir, "artifacts", artifact.name)
        versions = glob.glob(os.path.join(base, "v*"))
        v = len([p for p in versions if os.path.isdir(p)])
        adir = os.path.join(base, f"v{v}")
        os.makedirs(adir, exist_ok=True)
        for src, dest in artifact._files:
            dst = os.path.join(adir, dest)
            os.makedirs(os.path.dirname(dst), exist_ok=True)
            if os.path.isdir(src):
                shutil.copytree(src, dst, dirs_exist_ok=True)
            else:
                shutil.copy2(src, dst)
        for obj, name in artifact._objs:
            with open(os.path.join(adir, name + ".table.json"), "w") as f:
                json.dump(obj._serialize(self.dir), f)
        manifest = {
            "name": artifact.name, "type": artifact.type, "version": v,
            "metadata": _jsonable(artifact.metadata),
            "aliases": [a for a in (aliases or []) if a],
            "files": [d for _, d in artifact._files]
            + [n + ".table.json" for _, n in artifact._objs],
        }
        with open(os.path.join(base, f"v{v}.manifest.json"), "w") as f:
            json.dump(manifest, f, indent=1)
        artifact._dir = adir
        return artifact

    def use_artifact(self, name: str) -> Optional[Artifact]:
        """Resolve ``name[:alias]`` against this run's directory, the offline
        runs beside it, then those under WANDB_DIR (artifact resume)."""
        if ":" in name:
            name, alias = name.rsplit(":", 1)
        else:
            alias = "latest"
        roots = [os.path.dirname(self.dir)]
        env = os.environ.get("WANDB_DIR")
        if env and os.path.abspath(env) != os.path.abspath(roots[0]):
            roots.append(env)
        run_dirs = [d for root in roots for d in sorted(
            glob.glob(os.path.join(root, "offline-run-*")), reverse=True)]
        for run_dir in run_dirs:
            base = os.path.join(run_dir, "artifacts", name)
            best = None
            # by version number (v10 after v9), the last match wins
            for mf in sorted(glob.glob(os.path.join(base, "v*.manifest.json")),
                             key=_version):
                with open(mf) as f:
                    man = json.load(f)
                if alias == "latest" or alias in man.get("aliases", []):
                    best = man
            if best is not None:
                art = Artifact(best["name"], best["type"], best["metadata"])
                art._dir = os.path.join(base, f"v{best['version']}")
                return art
        return None

    def finish(self):
        global run
        with open(os.path.join(self.dir, "summary.json"), "w") as f:
            json.dump(self.summary, f, indent=1)
        run = None


def init(project: str = "desenet_tpu_torch", name: Optional[str] = None,
         config: Optional[Dict] = None, id: Optional[str] = None,
         resume: Optional[str] = None, job_type: str = "Training",
         dir: Optional[str] = None, **_) -> Run:
    global run
    root = dir or os.environ.get("WANDB_DIR", "wandb")
    os.makedirs(root, exist_ok=True)
    run_id = id or f"{int(time.time())}_{secrets.randbelow(1 << 20):x}"
    run = Run(root, project, run_id, name or "", config or {}, job_type)
    return run


def log(metrics: Dict, step: Optional[int] = None):
    assert run is not None, "call init() first"
    run.log(metrics, step=step)


def log_artifact(artifact: Artifact, aliases: Optional[List[str]] = None):
    assert run is not None, "call init() first"
    return run.log_artifact(artifact, aliases)
