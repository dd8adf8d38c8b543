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


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """One intra-op thread: as fast on these tiny tensors, and the parallel
    test workers then do not oversubscribe the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


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


def assert_same_metrics(got, want, seg_bar=1e-6):
    assert got["seen"] == want["seen"]
    for k in ("miou", "pix_acc"):
        assert abs(got[k] - want[k]) <= seg_bar, (k, got[k], want[k])
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


@pytest.mark.parametrize("argv", [["--int8"], ["--act-store", "fp8"]])
def test_cli_val_refuses_unported_flags(argv):
    """--int8 and --act-store are ported (tests/test_torch_quant_cli.py
    runs them against the JAX CLI); what stays refused, before any data is
    read, is what the JAX CLI refuses: the two together, and either on an
    ensemble of several --weights."""
    base = ["--data", "unused.yaml", "--weights", "sd.npz"]
    opt = cli_val.parse_opt(base + argv)
    assert opt.int8 != (opt.act_store == "fp8")
    with pytest.raises(ValueError, match="mutually exclusive"):
        cli_val.main(base + ["--int8", "--act-store", "fp8"])
    with pytest.raises(ValueError, match="ensemble"):
        cli_val.main(["--data", "unused.yaml", "--weights", "a.npz",
                      "b.npz"] + argv)


@pytest.fixture(scope="module")
def checkpoints(tmp_path_factory):
    """(JAX dir, port dir) of the two members of tests/torch_detect_case.py
    (member 0 is ``served_weights``)."""
    import torch_detect_case as D

    root = str(tmp_path_factory.mktemp("ckpts"))
    return [D.write_checkpoints(root, k) for k in (0, 1)]


def coco_instances(data_yaml: str, path: str) -> str:
    """The fake dataset's val labels as a COCO instances json (image ids
    the file stems, category ids the class indices)."""
    import json

    from desenet_tpu_torch.utils.general import load_yaml

    val = load_yaml(data_yaml)["val"]
    lab = os.path.join(os.path.dirname(os.path.dirname(val)), "DeLabels",
                       "val")
    images, anns = [], []
    for f in sorted(os.listdir(val)):
        stem = os.path.splitext(f)[0]
        images.append({"id": stem, "width": 96, "height": 96})
        for row in np.loadtxt(os.path.join(lab, stem + ".txt"), ndmin=2):
            c, x, y, w, h = row.tolist()
            anns.append({"id": len(anns) + 1, "image_id": stem,
                         "category_id": int(c), "iscrowd": 0,
                         "bbox": [(x - w / 2) * 96, (y - h / 2) * 96, w * 96,
                                  h * 96], "area": w * h * 96 * 96})
    with open(path, "w") as fh:
        json.dump({"images": images, "annotations": anns,
                   "categories": [{"id": i} for i in range(3)]}, fh)
    return path


@pytest.mark.parametrize("what", ["augment", "ensemble", "coco"])
def test_cli_val_flags_match_jax(dataset, checkpoints, what, tmp_path):
    """The flags the port's cli.val once refused, against the JAX CLI on
    the JAX checkpoints that the port's were crossed from: --augment,
    two --weights (an ensemble), and --save-json with --coco-anno (the
    COCO protocol's mAP in place of the 101-point one)."""
    from desenet_tpu.cli import val as jax_cli_val

    data_yaml, _ = dataset
    n = 2 if what == "ensemble" else 1
    kw = dict(batch_size=BATCH, imgsz=IMGSZ, half=False, workers=1,
              augment=what == "augment")
    if what == "coco":
        kw.update(save_json=True, coco_anno=coco_instances(
            data_yaml, str(tmp_path / "instances.json")))
    want = jax_cli_val.run(data_yaml, [c[0] for c in checkpoints[:n]],
                           save_dir=str(tmp_path / "jax"), **kw)
    got = cli_val.run(data_yaml, [c[1] for c in checkpoints[:n]],
                      save_dir=str(tmp_path / "port"), device="cpu", **kw)
    # the mean of several f32 forwards (TTA's three, the ensemble's two)
    # leaves a pixel or two of the 28672 at a near-tie of two classes'
    # logits (4e-6 apart where the two packages' logits differ by 4e-4),
    # each 2e-6 of mIoU
    assert_same_metrics(got, want, 1e-6 if what == "coco" else 1e-5)
    assert got["seen"] == 7 and got["miou"] > 0
    if what == "coco":
        from desenet_tpu_torch.eval.coco import evaluate_coco

        stats = evaluate_coco(kw["coco_anno"],
                              str(tmp_path / "port" / "predictions.json"),
                              quiet=True)
        assert (got["map"], got["map50"]) == (float(stats[0]),
                                              float(stats[1]))
        assert got["map50"] > 0


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
