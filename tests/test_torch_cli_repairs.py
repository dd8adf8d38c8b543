"""Two repairs of the port's CLIs, on the CPU.

``cli.serve --weights`` takes a checkpoint directory, as the JAX CLI does:
the predictor it builds from ``torch_detect_case``'s crossed checkpoint
answers as the JAX ``Predictor`` does on the JAX side of that checkpoint
(classes exact, boxes normalized by the native size within 1e-4, the names
of meta.json), and ``--state-dict`` and ``--seed`` still build from
``--cfg``. ``cli.detect``'s ``Speed:`` line stops the device time where
the program's work is done and counts the copies to the host as
postprocess, as the JAX CLI does: with a stubbed clock that only copies
advance, the device time reads 0.
"""

import os
import re
import types

import cv2
import numpy as np
import pytest
import torch

import torch_detect_case as D
from desenet_tpu.api import Predictor as JaxPredictor
from desenet_tpu_torch.cli import detect
from desenet_tpu_torch.cli import serve as cli_serve

CONF = 0.005
TOL = 1e-4


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    yield from D.one_thread()


@pytest.fixture(scope="module")
def case(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("repairs"))
    jdir, pdir = D.write_checkpoints(root, 0)
    src = os.path.join(root, "src")
    os.makedirs(src)
    rng = np.random.default_rng(3)
    for i, hw in enumerate([(64, 64), (48, 80), (96, 72)]):
        cv2.imwrite(os.path.join(src, f"im{i}.png"),
                    rng.integers(0, 256, (*hw, 3), dtype=np.uint8))
    return jdir, pdir, src


def images(src):
    return [cv2.imread(os.path.join(src, f)) for f in sorted(os.listdir(src))]


def serve_predictor(*argv):
    return cli_serve.build_predictor(cli_serve.parse_opt(
        [*argv, "--device", "cpu", "--no-half", "--img-size", "64",
         "--conf-thres", str(CONF)]))


def test_serve_weights_is_a_checkpoint_directory(case):
    jdir, pdir, src = case
    imgs = images(src)
    want = JaxPredictor(jdir, imgsz=64, conf_thres=CONF, half=False)(imgs)
    pred = serve_predictor("--weights", pdir)
    assert pred.names == D.DE_NAMES and pred.se_names == D.SE_NAMES
    got = pred(imgs)
    assert sum(len(d) for d in want.xyxy) > 0
    for g, w in zip(got.xyxyn, want.xyxyn):
        assert g.shape == w.shape
        np.testing.assert_array_equal(g[:, 5], w[:, 5])
        dist = np.abs(g[:, None, :5] - w[None, :, :5]).max(-1)
        assert dist.min(1).max() <= TOL and dist.min(0).max() <= TOL
    for g, w in zip(got.masks, want.masks):
        assert g.shape == w.shape and (g == w).mean() >= 0.999


def test_serve_state_dict_and_seed_build_from_cfg(case, tmp_path):
    _, pdir, src = case
    cfg = D.CFG
    sd = D.member_weights(0)
    npz = str(tmp_path / "sd.npz")
    np.savez(npz, **sd)
    by_npz = serve_predictor("--state-dict", npz, "--cfg", cfg)
    by_dir = serve_predictor("--weights", pdir)
    # the checkpoint's EMA is member 0's weights: the same answers, but
    # only the directory carries the names
    imgs = images(src)
    for g, w in zip(by_npz(imgs).xyxyn, by_dir(imgs).xyxyn):
        np.testing.assert_array_equal(g, w)
    assert by_npz.names != D.DE_NAMES
    by_seed = serve_predictor("--seed", "0", "--cfg", cfg)
    assert by_seed.spec.de_nc == by_npz.spec.de_nc
    with pytest.raises(SystemExit):  # one source only
        cli_serve.parse_opt(["--weights", pdir, "--seed", "0"])


def test_detect_device_time_excludes_the_copies(case, tmp_path, monkeypatch,
                                                capsys):
    _, pdir, src = case
    clock = [0.0]
    monkeypatch.setattr(detect, "time", types.SimpleNamespace(
        perf_counter=lambda: clock[0]))

    class Copied:
        """A device result whose copy to the host takes 1 s of the clock."""

        def __init__(self, t):
            self.t = t

        def cpu(self):
            clock[0] += 1.0
            return self.t.cpu()

    real = detect.detect_program

    def program(*a, **kw):
        nms, seg = real(*a, **kw)
        return types.SimpleNamespace(
            boxes=Copied(nms.boxes), scores=Copied(nms.scores),
            classes=Copied(nms.classes), num=Copied(nms.num)), Copied(seg)

    monkeypatch.setattr(detect, "detect_program", program)
    detect.run(pdir, src, imgsz=64, conf_thres=CONF, half=False, nosave=True,
               project=str(tmp_path), name="speed", device="cpu")
    line = [ln for ln in capsys.readouterr().out.splitlines()
            if ln.startswith("Speed:")][0]
    device_ms, post_ms = map(float, re.findall(r"([\d.]+)ms", line))
    # one image a batch, five copies each: 5 s of postprocess an image
    assert device_ms == 0.0 and post_ms == 5000.0, line
    assert torch.get_num_threads() == 1
