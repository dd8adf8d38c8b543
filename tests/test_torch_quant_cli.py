"""The int8 and fp8 entry points, JAX vs the port, on the CPU.

One module-scoped pair of checkpoints (``torch_detect_case``: tiny_psp2
with the boosted weights of ``testing.boosted_state``, whose activations
stay O(1) through the depth, in a JAX orbax checkpoint crossed into a port
checkpoint):

- ``load_predictor(..., int8=True, calib=[images])`` against the JAX
  package's ``Predictor(..., int8=True, calib=...)`` (f32, each calibrated
  on the same letterboxed images): the same detections, each matched by
  class, box within 1e-3 of the native image size and score within 1e-5,
  seg masks equal on at least 99% of the pixels;
  ``int8=True`` without ``calib`` raises ValueError in both; ``cli.serve
  --int8 --calib-dir`` builds the same int8 Predictor;
- ``cli.val`` with ``--int8`` (calibrated on 2 train batches) and with
  ``--act-store fp8`` on a ``make_fake_dataset`` split against the JAX
  package's ``cli.val.run`` with the same options: the same ``seen``,
  mIoU and pixAcc within 2e-3, P, R, mAP50 and mAP within 2e-2 (int8
  rounding differs by an LSB here and there between the two).
"""

import os
import sys

import cv2
import numpy as np
import pytest

import torch_detect_case as D
from desenet_tpu.api import Predictor as JaxPredictor
from desenet_tpu.cli import val as jax_val
from desenet_tpu_torch.api import Predictor, load_predictor
from desenet_tpu_torch.cli import serve as cli_serve
from desenet_tpu_torch.cli import val as cli_val
from desenet_tpu_torch.models import build_model
from desenet_tpu_torch.testing import boosted_state

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.join(os.path.dirname(HERE), "tools"))
from make_fake_dataset import generate  # noqa: E402

CONF = 0.005


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    yield from D.one_thread()


@pytest.fixture(scope="module")
def case(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("quant_cli"))
    sd = boosted_state(build_model(D.tiny_cfg())[0], seed=0)
    jdir, pdir = D.write_checkpoints(
        root, 0, {k: v.numpy() for k, v in sd.items()})
    data_yaml = generate(os.path.join(root, "ds"), n_train=8, n_val=6,
                         size=96, de_nc=3, se_nc=2, seed=5)
    rng = np.random.default_rng(3)
    imgs = [rng.integers(0, 256, (*hw, 3), dtype=np.uint8)
            for hw in [(64, 64), (48, 80), (96, 72)]]
    return root, jdir, pdir, data_yaml, imgs


def test_predictor_int8_matches_jax(case):
    _, jdir, pdir, _, imgs = case
    want = JaxPredictor(jdir, imgsz=64, conf_thres=CONF, half=False,
                        int8=True, calib=imgs)(imgs)
    pred = load_predictor(pdir, imgsz=64, conf_thres=CONF, half=False,
                          device="cpu", int8=True, calib=imgs)
    assert pred.model.quant.is_int8
    got = pred(imgs)
    assert sum(len(d) for d in want.xyxy) > 0
    for g, w in zip(got.xyxyn, want.xyxyn):
        assert g.shape == w.shape
        np.testing.assert_array_equal(np.sort(g[:, 5]), np.sort(w[:, 5]))
        # every detection of each has one of the other's class with its box
        # within 1e-3 and its score within 1e-5 (scores about 1e-6 apart
        # may come in either order: the two sum their f32 values in
        # different orders)
        same = ((g[:, None, 5] == w[None, :, 5])
                & (np.abs(g[:, None, :4] - w[None, :, :4]).max(-1) <= 1e-3)
                & (np.abs(g[:, None, 4] - w[None, :, 4]) <= 1e-5))
        assert same.any(1).all() and same.any(0).all()
    for g, w in zip(got.masks, want.masks):
        assert g.shape == w.shape and (g == w).mean() >= 0.99


def test_predictor_int8_needs_calib(case):
    _, jdir, pdir, _, _ = case
    with pytest.raises(ValueError, match="calib"):
        JaxPredictor(jdir, imgsz=64, half=False, int8=True)
    with pytest.raises(ValueError, match="calib"):
        load_predictor(pdir, imgsz=64, half=False, device="cpu", int8=True)
    with pytest.raises(ValueError, match="calib"):
        Predictor(D.tiny_cfg(), {}, imgsz=64, device="cpu", int8=True,
                  calib=[])


@pytest.mark.parametrize("mode", ["int8", "act_store"])
def test_cli_val_matches_jax(case, mode, capsys):
    root, jdir, pdir, data_yaml, _ = case
    kw = {"int8": True} if mode == "int8" else {"act_store": "fp8"}
    want = jax_val.run(data_yaml, jdir, batch_size=4, imgsz=64, half=False,
                       save_dir=os.path.join(root, f"jax_{mode}"), workers=1,
                       **kw)
    capsys.readouterr()
    argv = ["--data", data_yaml, "--weights", pdir, "--batch-size", "4",
            "--img-size", "64", "--no-half", "--device", "cpu", "--workers",
            "1", "--save-dir", os.path.join(root, f"port_{mode}")]
    argv += ["--int8"] if mode == "int8" else ["--act-store", "fp8"]
    got = cli_val.main(argv)
    out = capsys.readouterr().out
    if mode == "int8":
        assert ("int8: calibrated on 2 batches (bias_correct=True "
                "mse_clip=False weights_only=False per_channel=True "
                "fp_hops=1)") in out
    assert got["seen"] == want["seen"] > 0
    for k in ("miou", "pix_acc"):
        assert abs(got[k] - want[k]) <= 2e-3, (k, got[k], want[k])
    for k in ("mp", "mr", "map50", "map"):
        assert abs(got[k] - want[k]) <= 2e-2, (k, got[k], want[k])


def test_serve_int8_calibrates_on_a_directory(case, tmp_path):
    _, _, pdir, _, imgs = case
    for i, im in enumerate(imgs):
        cv2.imwrite(str(tmp_path / f"c{i}.png"), im)
    argv = ["--weights", pdir, "--img-size", "64", "--no-half", "--device",
            "cpu", "--conf-thres", str(CONF), "--int8"]
    with pytest.raises(SystemExit):
        cli_serve.parse_opt(argv)  # no --calib-dir
    args = cli_serve.parse_opt(argv + ["--calib-dir", str(tmp_path)])
    assert len(args.calib) == len(imgs)
    pred = cli_serve.build_predictor(args)
    want = load_predictor(pdir, imgsz=64, conf_thres=CONF, half=False,
                          device="cpu", int8=True,
                          calib=[cv2.imread(p) for p in args.calib])
    assert pred.model.quant.scales == want.model.quant.scales
    got, ref = pred(imgs), want(imgs)
    for g, w in zip(got.xyxy, ref.xyxy):
        np.testing.assert_array_equal(g, w)
