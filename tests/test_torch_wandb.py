"""The port's W&B sink (``desenet_tpu_torch/utils/wandb_logger.py`` over its
offline backend ``utils/wandb_offline.py``) against the JAX package's, on
the CPU:

- the same calls on both loggers (metrics, the validation media panel with
  boxes and masks, the evaluation table, a model artifact, an image, a
  named artifact, the epoch hook, the end) write the same run directory:
  the same files, JSON equal and arrays equal, up to the media files'
  time-stamped names;
- a model artifact and a dataset artifact written by either package are
  read by the other;
- the port's artifact resume by alias (``latest`` the highest version, past
  v9), dataset artifacts that carry each split's label files, the
  disabled mode, and ``online`` without the ``wandb`` package refused;
- ``cli.log_dataset``: the port's ``*_wandb.yaml`` (JSON text) read by
  PyYAML as the JAX package reads it, and the JAX package's read by the
  port's ``load_yaml``, equal;
- ``cli.train --wandb --upload-dataset --bbox-interval 1 --remat`` on the
  tiny config, one epoch at 64 px on the ``wandb-artifact://`` splits that
  ``cli.log_dataset`` wrote, then one more resumed from the run's model
  artifact: history, artifacts, aliases and counters.
"""

import json
import os
import re
import sys

import numpy as np
import pytest
import torch
import yaml

from desenet_tpu.cli import log_dataset as jax_log_dataset
from desenet_tpu.utils import wandb_logger as jax_wl
from desenet_tpu_torch.cli import log_dataset, train as cli_train
from desenet_tpu_torch.tools.make_fake_dataset import generate
from desenet_tpu_torch.utils import wandb_logger as port_wl
from desenet_tpu_torch.utils import checkpoint as ckpt
from desenet_tpu_torch.utils.general import load_yaml
from torch_detect_case import one_thread

HERE = os.path.dirname(os.path.abspath(__file__))
TINY = os.path.join(HERE, "configs", "tiny_psp2.yaml")
PREFIX = port_wl.WANDB_ARTIFACT_PREFIX
MEDIA = re.compile(r"media_\d+_\d+")
_threads = pytest.fixture(scope="module", autouse=True)(one_thread)


def _ckpt_dir(root):
    d = os.path.join(root, "ckpt")
    os.makedirs(d, exist_ok=True)
    with open(os.path.join(d, "meta.json"), "w") as f:
        f.write('{"cfg": "x"}')
    with open(os.path.join(d, "state.pt"), "wb") as f:
        f.write(bytes(range(64)))
    return d


def _drive(mod, root, ckpt_dir, tensors=False):
    """The same calls on one package's logger; returns the run dir."""
    wl = mod.WandbLogger(project="t", config={"lr0": 0.01, "epochs": 3},
                         resume_id="r1", dir=root, bbox_interval=1)
    assert wl.enabled
    rng = np.random.default_rng(0)
    pred = np.array([[10, 10, 50, 50, 0.9, 1], [5, 5, 20, 20, 0.4, 0]])
    seg = rng.integers(0, 2, (32, 32)).astype(np.uint8)
    im = rng.integers(0, 256, (32, 32, 3)).astype(np.uint8)
    wl.log({"train/box_loss": 0.5, "x/lr": np.float32(0.25)})
    args = ((torch.from_numpy(pred), torch.from_numpy(seg)) if tensors
            else (pred, seg))
    wl.val_one_image(*args, "img0.jpg", {0: "a", 1: "b"}, {0: "bg", 1: "fg"},
                     torch.from_numpy(im) if tensors else im)
    wl.end_epoch(best_result=True)
    wl.on_fit_epoch_end({"epoch": 1, "val/fitness": 0.3, "metrics/mIoU": ""})
    wl.log_model(ckpt_dir, epoch=1, fitness_score=0.42, best_model=True,
                 total_epochs=3)
    wl.log_image("sample", im, boxes=[{"position": {"minX": 1.0}}],
                 masks=seg, class_labels={0: "a"})
    wl.log_artifact(ckpt_dir, "model", "named_model", aliases=("v",))
    run_dir = wl.run.dir
    wl.on_train_end()
    return run_dir


def _norm(obj):
    if isinstance(obj, dict):
        return {k: _norm(v) for k, v in obj.items()}
    if isinstance(obj, list):
        return [_norm(v) for v in obj]
    if isinstance(obj, str):
        return MEDIA.sub("media", obj)
    return obj


def _tree(run_dir):
    """{normalized relative path: [contents]} of a run directory: JSON
    parsed and normalized, arrays as arrays, other files as bytes."""
    out = {}
    for base, _, names in os.walk(run_dir):
        for n in names:
            p = os.path.join(base, n)
            rel = MEDIA.sub("media", os.path.relpath(p, run_dir))
            if n.endswith(".jsonl"):
                with open(p) as f:
                    val = [_norm(json.loads(ln)) for ln in f]
            elif n.endswith(".json"):
                with open(p) as f:
                    val = _norm(json.load(f))
            elif n.endswith(".npy"):
                val = np.load(p).tolist()
            else:
                with open(p, "rb") as f:
                    val = f.read()
            out.setdefault(rel, []).append(val)
    return {k: sorted(v, key=repr) for k, v in out.items()}


@pytest.mark.parametrize("tensors", [False, True])
def test_logger_writes_the_jax_packages_run_files(tmp_path, tensors):
    ck = _ckpt_dir(str(tmp_path))
    jax_dir = _drive(jax_wl, str(tmp_path / "jax"), ck)
    port_dir = _drive(port_wl, str(tmp_path / "port"), ck, tensors)
    want, got = _tree(jax_dir), _tree(port_dir)
    assert sorted(got) == sorted(want)
    assert any(k.startswith("files/media") for k in got)
    assert any("run_r1_model/v0.manifest.json" in k for k in got)
    for k in want:
        assert got[k] == want[k], k


def test_each_package_reads_the_others_artifacts(tmp_path, monkeypatch):
    monkeypatch.delenv("WANDB_DIR", raising=False)
    root = str(tmp_path / "runs")
    ck = _ckpt_dir(str(tmp_path))
    split = tmp_path / "ds" / "Images" / "train"
    split.mkdir(parents=True)
    for i in range(3):
        np.save(split / f"x{i}.npy", np.zeros(2))  # files of the split
        (split / f"im{i}.jpg").write_bytes(bytes([i]) * 8)
    for writer, reader in ((jax_wl, port_wl), (port_wl, jax_wl)):
        w = writer.WandbLogger(project="t", dir=root)
        w.log_model(ck, epoch=0, fitness_score=0.1, best_model=True)
        w.log_dataset_artifact({"train": str(split)}, {0: "a"})
        model_art = f"run_{w.run.id}_model"
        w.on_train_end()
        r = reader.WandbLogger(project="t", dir=root)
        path = r.download_model_artifact(f"{PREFIX}{model_art}:best")
        assert path is not None
        with open(os.path.join(path, "state.pt"), "rb") as f:
            assert f.read() == bytes(range(64))
        data = r.download_dataset_artifact(f"{PREFIX}train_dataset")
        found = sorted(f for _, _, fs in os.walk(data) for f in fs
                       if f.endswith(".jpg"))
        assert found == ["im0.jpg", "im1.jpg", "im2.jpg"]
        r.on_train_end()


def test_model_artifact_aliases_and_resume(tmp_path):
    ck = _ckpt_dir(str(tmp_path))
    root = str(tmp_path / "runs")
    w = port_wl.WandbLogger(project="t", dir=root)
    for epoch in range(12):
        with open(os.path.join(ck, "meta.json"), "w") as f:
            json.dump({"epoch": epoch}, f)
        w.log_model(ck, epoch, fitness_score=epoch / 10,
                    best_model=epoch == 4, total_epochs=12)
    name = f"run_{w.run.id}_model"
    w.on_train_end()
    r = port_wl.WandbLogger(project="t", dir=root)

    def epoch_of(alias):
        path = r.download_model_artifact(f"{PREFIX}{name}:{alias}")
        with open(os.path.join(path, "meta.json")) as f:
            return json.load(f)["epoch"]

    assert epoch_of("latest") == 11 and epoch_of("last") == 11
    assert epoch_of("best") == 4 and epoch_of("epoch 7") == 7
    assert r.download_model_artifact(f"{PREFIX}{name}") is not None
    assert r.download_model_artifact(f"{PREFIX}{name}:nope") is None
    assert r.download_model_artifact("runs/exp/last") is None
    r.on_train_end()


def test_dataset_artifact_carries_labels(tmp_path):
    from desenet_tpu_torch.data.dataset import img2label_paths

    data = load_yaml(generate(str(tmp_path / "fk"), n_train=3, n_val=1,
                              size=64, seed=0))
    w = port_wl.WandbLogger(project="t", dir=str(tmp_path / "runs"))
    out = w.log_dataset_artifact(data, {0: "a"})
    assert out["train"] == f"{PREFIX}train_dataset:latest"
    local = w.download_dataset_artifact(out["train"])
    imgs = sorted(os.path.join(b, f) for b, _, fs in os.walk(local)
                  for f in fs if f.endswith(".jpg"))
    assert len(imgs) == 3
    for de, se, img in zip(*img2label_paths(imgs), imgs):
        name = os.path.basename(img)[:-4] + ".txt"
        for lab, kind in ((de, "DeLabels"), (se, "SeLabels")):
            src = tmp_path / "fk" / kind / "train" / name
            assert os.path.isfile(lab) and open(lab).read() == \
                src.read_text(), lab
    w.on_train_end()


def test_disabled_and_online_modes(tmp_path, monkeypatch):
    wl = port_wl.WandbLogger(project="t", dir=str(tmp_path / "wb"),
                             mode="disabled")
    assert not wl.enabled
    wl.log({"a": 1.0})
    wl.val_one_image(np.zeros((0, 6)), np.zeros((4, 4)), "x.jpg", {}, {},
                     np.zeros((4, 4, 3), np.uint8))
    wl.end_epoch()
    wl.log_model(str(tmp_path), 0, 0.0)
    assert wl.download_model_artifact(f"{PREFIX}x") is None
    wl.on_train_end()
    assert not (tmp_path / "wb").exists()
    # online needs the real package: a ./wandb directory of runs is not it
    import types
    monkeypatch.setitem(sys.modules, "wandb", types.ModuleType("wandb"))
    with pytest.raises(ImportError, match="wandb package"):
        port_wl.WandbLogger(project="t", mode="online")


def test_log_dataset_yaml_loads_in_both_packages(tmp_path, monkeypatch):
    monkeypatch.setenv("WANDB_DIR", str(tmp_path / "wandb"))
    data = generate(str(tmp_path / "fk"), n_train=2, n_val=1, size=64,
                    seed=1)
    out = os.path.join(os.path.dirname(data), "data_wandb.yaml")
    jax_log_dataset.main(["--data", data, "--project", "t"])
    from_jax = load_yaml(out)  # PyYAML's text: the port reads it
    path = log_dataset.main(["--data", data, "--project", "t"])
    assert str(path) == out
    with open(out) as f:
        text = f.read()
    json.loads(text)  # JSON text: no PyYAML needed on the port's side
    from_port = yaml.safe_load(text)  # as the JAX package reads it
    assert from_port == load_yaml(out) == from_jax
    assert from_port["train"] == f"{PREFIX}train_dataset:latest"
    assert from_port["de"] == load_yaml(data)["de"]


def test_train_cli_with_wandb_and_artifact_resume(tmp_path, monkeypatch):
    monkeypatch.setenv("WANDB_DIR", str(tmp_path / "wandb"))
    data = generate(str(tmp_path / "fk"), n_train=4, n_val=2, size=64,
                    seed=2)
    wb_yaml = str(log_dataset.create_dataset_artifact(data))
    argv = ["--data", wb_yaml, "--cfg", TINY, "--batch-size", "2",
            "--img-size", "64", "--dtype", "float32", "--nbs", "2",
            "--warmup-floor", "2", "--device", "cpu", "--no-tb",
            "--workers", "1", "--noautoanchor", "--project",
            str(tmp_path / "runs"), "--name", "wb", "--wandb",
            "--bbox-interval", "1", "--remat"]
    res = cli_train.main(argv + ["--epochs", "1", "--upload-dataset"])
    save_dir = res["save_dir"]
    runs = [d for d in os.listdir(save_dir) if d.startswith("offline-run-")]
    assert len(runs) == 1
    run_dir = os.path.join(save_dir, runs[0])
    run_id = runs[0][len("offline-run-"):]
    with open(os.path.join(run_dir, "history.jsonl")) as f:
        hist = [json.loads(ln) for ln in f]
    assert [h["epoch"] for h in hist] == [0]
    assert np.isfinite([hist[0][f"train/{k}_loss"]
                        for k in ("box", "obj", "cls", "seg")]).all()
    assert all(0 <= v <= 1 for k, v in hist[0].items()
               if k.startswith("metrics/"))
    arts = os.path.join(run_dir, "artifacts")
    assert {"train_dataset", "val_dataset", f"run_{run_id}_model"} <= set(
        os.listdir(arts))
    with open(os.path.join(arts, f"run_{run_id}_model",
                           "v0.manifest.json")) as f:
        man = json.load(f)
    assert {"latest", "last", "epoch 0", "best"} <= set(man["aliases"])
    assert man["metadata"]["epochs_trained"] == 1
    with open(os.path.join(run_dir, "config.json")) as f:
        assert json.load(f)["remat"] is True

    res = cli_train.main(argv + ["--epochs", "2", "--exist-ok", "--resume",
                                 f"{PREFIX}run_{run_id}_model:latest"])
    assert res["save_dir"] == save_dir
    last = ckpt.load_checkpoint(os.path.join(save_dir, "last"))
    assert int(last["counters"]["epoch"]) == 1
    assert int(last["counters"]["step"]) == 2 * 2
    with open(os.path.join(save_dir, "results.csv")) as f:
        assert len(f.read().strip().splitlines()) == 3  # header, 2 epochs
