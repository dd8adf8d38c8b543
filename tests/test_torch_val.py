"""The validation path as a whole, JAX vs port, on the CPU.

A synthetic dataset from ``tools/make_fake_dataset.py`` (64 px, tiny_psp2's
3 detection and 2 seg classes) is loaded once by the JAX package's data
pipeline; the JAX ``Validator`` (its model on converted weights, NMS on the
XLA backend) and the port's (f32 on the CPU, NMS through the plain K3) run
over the same batches with the same calibrated random weights
(``test_torch_slice.served_weights``). Equal ``seen``; mIoU and pixAcc at
1e-6 (class maps equal but for near-ties of f32 logits); mp, mr, mAP50 and
mAP at atol 1e-3 (detections at the same tolerances as
tests/test_torch_nms_val.py). The port's ``cli/val.run`` on an exported npz
and ``seg_validation`` / ``cli/show_seg_miou`` then give the same numbers.
"""

import os
import sys

import jax
import numpy as np
import pytest
import torch

from desenet_tpu.data import create_mixed_dataloader
from desenet_tpu.eval.validator import Validator as JaxValidator
from desenet_tpu.eval.validator import seg_validation as jax_seg_validation
from desenet_tpu.models import build_model as jax_build_model
from desenet_tpu.utils.torch_convert import convert_state_dict
from desenet_tpu_torch.cli import show_seg_miou
from desenet_tpu_torch.cli import val as cli_val
from desenet_tpu_torch.eval import Validator, seg_validation
from desenet_tpu_torch.models import build_model
from desenet_tpu_torch.utils.convert import load_state_dict
from test_torch_slice import served_weights, tiny_cfg

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.join(os.path.dirname(HERE), "tools"))
from make_fake_dataset import generate  # noqa: E402

IMGSZ, BATCH = 64, 4


@pytest.fixture(scope="module")
def dataset(tmp_path_factory):
    root = tmp_path_factory.mktemp("fakeds")
    data_yaml = generate(str(root), n_train=2, n_val=7, size=96, de_nc=3,
                         se_nc=2, seed=21)
    loader, _ = create_mixed_dataloader(
        os.path.join(str(root), "Images", "val"), img_size=IMGSZ,
        batch_size=BATCH, augment=False, rect=True, pad=0.5, stride=32,
        workers=1)
    return data_yaml, list(loader)


@pytest.fixture(scope="module")
def jax_side():
    model, spec = jax_build_model(tiny_cfg())
    x = jax.ShapeDtypeStruct((1, IMGSZ, IMGSZ, 3), np.float32)
    shapes = jax.eval_shape(
        lambda v: model.init({"params": jax.random.PRNGKey(0),
                              "dropout": jax.random.PRNGKey(0)}, v,
                             train=False), x)
    template = jax.tree.map(lambda s: np.zeros(s.shape, s.dtype), shapes)
    variables, report = convert_state_dict(served_weights(), template, spec)
    assert not report["missing"]
    return model, variables


def port_model(**kw):
    model, _ = build_model(tiny_cfg(), **kw)
    load_state_dict(model, {k: torch.from_numpy(v)
                            for k, v in served_weights().items()})
    return model


def assert_same_metrics(got, want):
    assert got["seen"] == want["seen"]
    for k in ("miou", "pix_acc"):
        assert abs(got[k] - want[k]) <= 1e-6, (k, got[k], want[k])
    for k in ("mp", "mr", "map50", "map"):
        assert abs(got[k] - want[k]) <= 1e-3, (k, got[k], want[k])
    assert set(got["per_class"]) == set(want["per_class"])


@pytest.mark.parametrize("kw", [dict(), dict(single_cls=True),
                                dict(save_hybrid=True)])
def test_validator_matches_jax(dataset, jax_side, kw):
    _, batches = dataset
    jmodel, variables = jax_side
    nc = 1 if kw.get("single_cls") else 3
    want = JaxValidator(jmodel, nc=nc, se_nc=2, **kw).run(variables, batches)
    got = Validator(port_model(decode_cat=False), nc=nc, se_nc=2,
                    **kw).run(batches)
    assert_same_metrics(got, want)
    assert got["seen"] == 7 and len(got["speed_ms"]) == 3
    if not kw:
        assert got["map50"] > 0 and got["miou"] > 0


def test_cli_val_on_exported_npz(dataset, tmp_path):
    data_yaml, batches = dataset
    npz = str(tmp_path / "sd.npz")
    np.savez(npz, **served_weights())
    # the CLI builds the one-conv FusedFocus stem, as the JAX package does
    want = Validator(port_model(fuse_focus=True), nc=3, se_nc=2).run(batches)
    save_dir = str(tmp_path / "run")
    got = cli_val.run(data_yaml, npz, cfg=os.path.join(HERE, "configs",
                                                       "tiny_psp2.yaml"),
                      batch_size=BATCH, imgsz=IMGSZ, half=False,
                      save_dir=save_dir, workers=1, save_txt=True,
                      save_json=True, device="cpu", seg_head_fused=True)
    for k in ("seen", "mp", "mr", "map50", "map"):
        assert got[k] == want[k], k
    for k in ("miou", "pix_acc"):
        assert abs(got[k] - want[k]) <= 1e-6, k
    assert os.path.isfile(os.path.join(save_dir, "predictions.json"))
    assert len(os.listdir(os.path.join(save_dir, "labels"))) == 7


def test_cli_val_speed_task(dataset, tmp_path, capsys):
    data_yaml, _ = dataset
    npz = str(tmp_path / "sd.npz")
    np.savez(npz, **served_weights())
    ms = cli_val.main(["--data", data_yaml, "--weights", npz, "--cfg",
                       os.path.join(HERE, "configs", "tiny_psp2.yaml"),
                       "--task", "speed", "--img-size", "64",
                       "--batch-size", "2", "--no-half", "--device", "cpu",
                       "--seg-head-fused"])
    assert ms > 0 and "ms/image at batch 2, 64px on cpu" in capsys.readouterr(
    ).out


@pytest.mark.parametrize("argv", [
    ["--augment"], ["--int8"], ["--act-store", "fp8"],
    ["--coco-anno", "instances.json"], ["--weights", "a.npz", "b.npz"]])
def test_cli_val_refuses_unported_flags(argv):
    base = ["--data", "unused.yaml", "--weights", "sd.npz"]
    if argv[0] == "--weights":
        base = base[:2]
    with pytest.raises(NotImplementedError, match="ROADMAP.md"):
        cli_val.main(base + argv)


def test_seg_validation_and_show_seg_miou_match_jax(dataset, jax_side,
                                                    tmp_path):
    data_yaml, batches = dataset
    jmodel, variables = jax_side
    want = jax_seg_validation(jmodel, variables, 2, batches)
    got = seg_validation(port_model(), 2, batches)
    assert abs(got - want) <= 1e-6
    npz = str(tmp_path / "sd.npz")
    np.savez(npz, **served_weights())
    shown = show_seg_miou.run(data_yaml, npz,
                              cfg=os.path.join(HERE, "configs",
                                               "tiny_psp2.yaml"),
                              batch_size=BATCH, imgsz=IMGSZ, half=False,
                              workers=1, device="cpu")
    assert abs(shown - want) <= 1e-6
