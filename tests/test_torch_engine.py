"""The port's training engine and CLI (``desenet_tpu_torch/train/engine.py``,
``cli/train.py``) against the JAX package's engine, on the CPU.

One JAX engine run per module (tiny_psp2, 64 px, 6 train and 2 val images
of ``tools/make_fake_dataset.py``, batch 2, nominal batch 4 so the warmup
mixes accumulating and stepping batches, 2 epochs, float32, one device,
autoanchor on), with its ``init_model`` jitted and its variables kept, and
its training step wrapped to record each step's metrics. The port's engine
then trains from those initial weights (converted by
``utils/convert.py:state_dict_from_jax`` and passed as ``--weights``) on the
same data. Checked: the per-step lr and accumulate decisions equal the JAX
engine's exactly, and the step's schedule arguments (batches an epoch,
warmup iterations, nominal and real batch, gains) with them, so the warmup
momentum, a function of those alone, is the same too; the first step's
losses are within the f32 bar of the training-step tests
(``testing.TRAIN_LOSS_BAR``); the run directory has the JAX engine's
layout; resume and the CLI's bare ``--resume`` go on from the counters;
``cli/val.py`` validates ``best_stripped``; ``--spatial`` above 1 (not
ported) raises NotImplementedError; ``--device cuda`` with no card raises.
"""

import csv
import dataclasses
import json
import os
import sys

import jax
import numpy as np
import pytest
import torch
from flax import traverse_util

from desenet_tpu.train import engine as jax_engine
from desenet_tpu_torch.cli import train as cli_train
from desenet_tpu_torch.models import build_model
from desenet_tpu_torch.testing import TRAIN_LOSS_BAR
from desenet_tpu_torch.train import create_train_state
from desenet_tpu_torch.train import engine
from desenet_tpu_torch.utils import checkpoint as ckpt
from desenet_tpu_torch.utils.convert import load_state_dict, state_dict_from_jax

HERE = os.path.dirname(os.path.abspath(__file__))
TINY = os.path.join(HERE, "configs", "tiny_psp2.yaml")
STEP_ARGS = ("nb", "warmup_iters", "nominal_bs", "batch_size", "det_gain",
             "seg_gain", "freeze", "fused_seg")
LOSSES = ("loss", "lbox", "lobj", "lcls", "lseg")


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """One intra-op thread: as fast on these tiny tensors, and the parallel
    test workers then do not oversubscribe the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def recording(make, log):
    """``make_train_step`` that keeps its keyword arguments and each step's
    metrics as floats."""

    def wrapped(*a, **kw):
        log["args"] = {k: kw[k] for k in STEP_ARGS}
        step = make(*a, **kw)

        def run(state, batch, *rest):
            state, m = step(state, batch, *rest)
            log["steps"].append({k: float(v) for k, v in m.items()})
            return state, m
        return run
    return wrapped


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    pytest.importorskip("cv2", reason="the fake dataset and the training "
                        "augmentations need cv2")
    pytest.importorskip("PIL", reason="the loaders decode images with PIL")
    sys.path.insert(0, os.path.join(os.path.dirname(HERE), "tools"))
    from make_fake_dataset import generate

    root = tmp_path_factory.mktemp("engine")
    data = generate(str(root / "ds"), n_train=6, n_val=2, size=64, de_nc=3,
                    se_nc=2, seed=9)
    common = dict(data=data, cfg=TINY, epochs=2, batch_size=2, imgsz=64,
                  workers=2, dtype="float32", nbs=4, warmup_floor=3,
                  use_tb=False, max_targets=16, seed=0)
    logs = {"jax": {"steps": []}, "port": {"steps": []}}
    init = {}
    orig_init = jax_engine.init_model

    def jitted_init(model, rng, img_size, batch):
        init["variables"] = jax.device_get(jax.jit(
            lambda r: orig_init(model, r, img_size, batch))(rng))
        return init["variables"]

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jax_engine, "init_model", jitted_init)
        mp.setattr(jax_engine, "make_train_step", recording(
            jax_engine.make_train_step, logs["jax"]))
        jres = jax_engine.train(jax_engine.TrainConfig(
            **common, project=str(root / "jax"), n_devices=1))

    # the JAX engine's initial weights as a port checkpoint, for --weights
    model, spec = build_model(TINY, nc=3, se_nc=2, seg_upsample=False,
                              train=True)
    sd, _ = state_dict_from_jax(
        traverse_util.flatten_dict(init["variables"], sep="/"), spec)
    load_state_dict(model, sd)
    opt_cfg = engine.loss_and_schedule(engine.load_hyp(), spec, 64, 2)[1]
    init_dir = str(root / "init")
    ckpt.save_checkpoint(init_dir, create_train_state(model, opt_cfg), 0,
                         0.0, {})

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(engine, "make_train_step", recording(
            engine.make_train_step, logs["port"]))
        cfg = engine.TrainConfig(**common, project=str(root / "port"),
                                 weights=init_dir, device="cpu")
        pres = engine.train(cfg)
    return {"jax": jres, "port": pres, "logs": logs, "cfg": cfg,
            "data": data, "root": root}


def test_schedule_equals_the_jax_engine(runs):
    j, p = runs["logs"]["jax"], runs["logs"]["port"]
    assert p["args"] == j["args"]
    assert j["args"]["nb"] == 3 and j["args"]["warmup_iters"] == 9
    assert len(p["steps"]) == len(j["steps"]) == 6
    assert [s["lr"] for s in p["steps"]] == [s["lr"] for s in j["steps"]]
    stepped = [s["stepped"] for s in p["steps"]]
    assert stepped == [s["stepped"] for s in j["steps"]]
    assert 0 in stepped and 1 in stepped  # accumulating and stepping


def test_first_step_losses_within_the_f32_bar(runs):
    j, p = runs["logs"]["jax"]["steps"][0], runs["logs"]["port"]["steps"][0]
    for k in LOSSES:
        np.testing.assert_allclose(p[k], j[k], rtol=TRAIN_LOSS_BAR[
            torch.float32], atol=0, err_msg=k)


def read_csv(save_dir):
    with open(os.path.join(save_dir, "results.csv")) as fh:
        return list(csv.DictReader(fh))


def test_run_directory_has_the_jax_layout(runs):
    jd, pd = runs["jax"]["save_dir"], runs["port"]["save_dir"]
    with open(os.path.join(jd, "results.csv")) as a, \
            open(os.path.join(pd, "results.csv")) as b:
        assert a.readline() == b.readline()
    rows = read_csv(pd)
    assert [r["epoch"] for r in rows] == ["0", "1"]
    for r in rows:
        vals = [float(v) for v in r.values()]
        assert np.isfinite(vals).all()
        assert all(0 <= float(r[k]) <= 1 for k in r if k.startswith(
            "metrics/"))
    for name in ("last", "best", "best_stripped"):
        assert os.path.isfile(os.path.join(pd, name, "meta.json")), name
        assert os.path.isdir(os.path.join(jd, name)), name
    metas = [json.load(open(os.path.join(d, "last", "meta.json")))
             for d in (jd, pd)]
    assert set(metas[1]) - {"anchors"} == set(metas[0]) | {"format"}
    for k in ("cfg", "imgsz", "de_nc", "se_nc", "de_names", "se_names",
              "hyp"):
        assert metas[1][k] == metas[0][k], k
    import yaml

    for name in ("hyp.yaml", "opt.yaml"):
        with open(os.path.join(jd, name)) as a, \
                open(os.path.join(pd, name)) as b:
            want, got = yaml.safe_load(a), json.load(b)
        assert set(got) - {"device"} == set(want)
        # the runs differ in these on purpose (the JAX one on one device)
        differ = ("project", "weights", "n_devices")
        assert {k: got[k] for k in want if k not in differ} == \
            {k: v for k, v in want.items() if k not in differ}
    last = ckpt.load_checkpoint(os.path.join(pd, "last"))["counters"]
    assert (last["epoch"], last["step"]) == (1, 6)
    assert 0.0 <= runs["port"]["best_fitness"] <= 1.0


def test_resume_continues_the_counters(runs):
    pd = runs["port"]["save_dir"]
    before = ckpt.load_checkpoint(os.path.join(pd, "last"))["counters"]
    cfg = dataclasses.replace(runs["cfg"], epochs=3, exist_ok=True,
                              name=os.path.basename(pd),
                              resume=os.path.join(pd, "last"))
    out = engine.train(cfg)
    assert out["save_dir"] == pd
    rows = read_csv(pd)
    assert [r["epoch"] for r in rows] == ["0", "1", "2"]
    after = ckpt.load_checkpoint(os.path.join(pd, "last"))["counters"]
    assert after["epoch"] == 2 and after["step"] == before["step"] + 3
    assert after["ema_updates"] > before["ema_updates"]
    assert after["best_fitness"] >= before["best_fitness"]


def test_bare_resume_restores_opt_yaml(runs, monkeypatch):
    """Bare --resume finds the newest ``last`` under the working directory
    and takes the run's own options from its opt.yaml, among them
    ``--device cpu`` (the CLI's default, cuda, would raise here)."""
    pd = runs["port"]["save_dir"]
    monkeypatch.chdir(os.path.dirname(pd))
    res = cli_train.main(["--data", runs["data"], "--resume"])
    assert os.path.abspath(res["save_dir"]) == os.path.abspath(pd)


def test_val_cli_validates_best_stripped(runs):
    from desenet_tpu_torch.cli import val as cli_val

    pd = runs["port"]["save_dir"]
    res = cli_val.main(["--data", runs["data"], "--weights",
                        os.path.join(pd, "best_stripped"), "--device", "cpu",
                        "--no-half", "--img-size", "64", "--batch-size", "2",
                        "--workers", "1", "--save-dir",
                        str(runs["root"] / "val")])
    assert res["seen"] == 2 and 0 <= res["miou"] <= 1


@pytest.mark.parametrize("opts", [
    dict(multi_scale=True, image_weights=True, noval=True),
    dict(quad=True, batch_size=4, save_period=1),
    dict(rect=True, adam=True, linear_lr=True, freeze=2, single_cls=True,
         fused_seg_loss=False),
], ids=["multi_scale_image_weights_noval", "quad_save_period",
        "rect_adam_freeze_single_cls_materialized"])
def test_engine_options_run(runs, opts):
    """The engine's other options, two epochs each from the seeded init."""
    from desenet_tpu_torch.utils.callbacks import Callbacks

    cfg = dataclasses.replace(runs["cfg"], weights="", name="opts",
                              **opts)
    vals = []
    cbs = Callbacks()
    cbs.register_action("on_val_start", callback=lambda: vals.append(1))
    res = engine.train(cfg, cbs)
    rows = read_csv(res["save_dir"])
    assert [r["epoch"] for r in rows] == ["0", "1"]
    for r in rows:
        assert np.isfinite([float(v) for v in r.values()]).all()
    assert len(vals) == (1 if cfg.noval else 2)  # noval: the last only
    for e in range(2):
        assert os.path.isdir(os.path.join(res["save_dir"], f"epoch{e}")) \
            == (cfg.save_period == 1)
    last = ckpt.load_checkpoint(os.path.join(res["save_dir"], "last"))
    nb = 1 if cfg.quad else 3
    assert last["counters"]["step"] == 2 * nb
    if cfg.single_cls:
        assert last["meta"]["de_nc"] == 1 and last["meta"]["de_names"] == [
            "item"]


REFUSED = [["--spatial", "2"], ["--wandb"],
           ["--upload-dataset"], ["--entity", "me"],
           ["--bbox-interval", "3"], ["--artifact-alias", "v1"], ["--remat"]]


@pytest.mark.parametrize("flag", REFUSED, ids=lambda f: f[0])
def test_unported_flags_raise(flag, tmp_path, monkeypatch):
    """The flags the port once refused are ported (--spatial above 1, the
    W&B flags, --remat): each reaches the engine, which (no card) refuses
    the default --device cuda, before any run directory. --spatial's runs
    are in tests/test_torch_spatial.py."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    want = (RuntimeError, "--device cpu")
    with pytest.raises(want[0], match=want[1]):
        cli_train.main(["--data", "x.yaml", "--project", str(tmp_path)]
                       + flag)
    assert not os.listdir(tmp_path)  # refused before any run directory


def test_multi_process_launch_raises(monkeypatch):
    """A multi-process launch is ported (tests/test_torch_multiproc_*.py);
    an environment that names a coordinator but not the process count and
    id is refused before anything joins."""
    monkeypatch.setenv("DESENET_COORDINATOR", "localhost:1234")
    monkeypatch.delenv("DESENET_NUM_PROCESSES", raising=False)
    with pytest.raises(ValueError, match="DESENET_NUM_PROCESSES"):
        cli_train.main(["--data", "x.yaml"])


@pytest.mark.parametrize("flag", [["--fast-decode"],
                                  ["--cache-images", "ram"],
                                  ["--n-devices", "2"]],
                         ids=lambda f: f[0])
def test_formerly_refused_flags(flag, tmp_path, monkeypatch):
    """The flags that the port refused until the host data path and the
    multi-process engine were ported reach the engine: the scaled decode
    without libjpeg and --n-devices without the cards are refused before
    any run directory; the image cache runs on to the missing dataset."""
    from desenet_tpu_torch import native

    monkeypatch.setattr(native, "jpeg_available", lambda: False)
    want = {"--fast-decode": (RuntimeError, "libjpeg"),
            "--cache-images": (FileNotFoundError, "x.yaml"),
            "--n-devices": (RuntimeError, "CUDA card")}[flag[0]]
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    argv = ["--data", "x.yaml", "--project", str(tmp_path)] + flag
    if flag[0] != "--n-devices":
        argv += ["--device", "cpu"]
    with pytest.raises(want[0], match=want[1]):
        cli_train.main(argv)
    assert not os.listdir(tmp_path) or flag[0] == "--cache-images"


def test_multi_process_conditions():
    """The JAX engine's conditions on a run of several processes."""
    cfg = engine.TrainConfig(batch_size=8)
    engine.check_processes(cfg, 2)
    for bad, match in ((dict(batch_size=9), "not divisible"),
                       (dict(batch_size=4, quad=True), "--quad"),
                       (dict(batch_size=8, rect=True), "--rect"),
                       (dict(batch_size=8, n_devices=4), "--n-devices 4")):
        with pytest.raises(ValueError, match=match):
            engine.check_processes(engine.TrainConfig(**bad), 2)
    with pytest.raises(ValueError, match="--n-devices 2"):
        engine.check_processes(engine.TrainConfig(n_devices=2), 1)


def test_cuda_without_a_card_raises(monkeypatch, tmp_path):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        cli_train.main(["--data", "x.yaml", "--project", str(tmp_path),
                        "--sync-bn"])
