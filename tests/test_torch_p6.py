"""The P6 model ``yolov5x6_seg`` (four detection levels, strides 8 to 64)
on the CPU, at a tiny width.

- Its forward against the benchmark's plain reference
  (``benchmark/reference/desenet.py``, which imports nothing of the
  program) in float64 on seeded weights (the port's ``init_weights`` and
  ``testing.randomize_bn``, BN statistics calibrated by the reference) at
  256x256: the decode of all 4080 anchors and the 1/8 seg logits. (The
  JAX package's forward of the same model: tests/test_torch_model_family.py.)
- Four levels at strides (8, 16, 32, 64); ``Predictor.run_batch`` and
  ``__call__`` on a 16:9 frame; ``Predictor`` refuses an ``imgsz`` that is
  no multiple of the model's largest stride.
- ``DetectionLoss.balance`` against YOLOv5 v5.0's per-level list, and the
  objectness loss as the balance-weighted sum of its levels; a four-level
  train step, ``check_anchors`` and ``Validator``.
"""

import json
import types

import numpy as np
import pytest
import torch

from benchmark.reference import desenet as R
from desenet_tpu_torch.api import Predictor
from desenet_tpu_torch.eval.validator import Validator
from desenet_tpu_torch.losses import DetectionLoss
from desenet_tpu_torch.losses.detection import level_balance
from desenet_tpu_torch.models import build_model, config_path, init_weights
from desenet_tpu_torch.testing import randomize_bn, tiny_cfg, train_batch
from desenet_tpu_torch.train import create_train_state, make_train_step
from desenet_tpu_torch.train.engine import load_hyp, loss_and_schedule
from desenet_tpu_torch.utils.autoanchor import check_anchors
from desenet_tpu_torch.utils.convert import load_state_dict

IMGSZ = 256
ANCHORS_256 = 3 * sum((IMGSZ // s) ** 2 for s in (8, 16, 32, 64))  # 4080


def tiny_x6() -> dict:
    """yolov5x6_seg's rows at width 0.125 (every depth as shipped)."""
    with open(config_path("yolov5x6_seg")) as fh:
        cfg = json.load(fh)
    cfg.update(width_multiple=0.125)
    return cfg


@pytest.fixture(scope="module")
def weights():
    """Seeded weights under the reference's names, float64, BN statistics
    calibrated on two frames by the reference, so that the activations
    keep their scale through the 12-deep C3s."""
    cfg = tiny_x6()
    model, _ = build_model(cfg)
    init_weights(model, torch.Generator().manual_seed(21))
    randomize_bn(model, 22)
    sd = {k: v.double() for k, v in model.state_dict().items()
          if not k.endswith("num_batches_tracked")}
    g = torch.Generator().manual_seed(5)
    R.calibrate_bn(cfg, sd, torch.rand((2, 3, IMGSZ, IMGSZ), generator=g,
                                       dtype=torch.float64), var_floor=2.0)
    return cfg, sd


def test_shipped_config_has_four_levels():
    model, spec = build_model(config_path("yolov5x6_seg"))
    assert spec.det_strides == (8, 16, 32, 64)
    assert spec.det_layer == 34 and spec.seg_layer == 33
    assert spec.layers[33].f == (22, 25, 28)
    assert spec.layers[34].f == (23, 26, 29, 32)
    assert [ls.i for ls in spec.layers if ls.stride == 64] == [
        9, 10, 11, 12, 30, 31, 32]
    assert model.model[34].nl == 4


def test_forward_matches_the_plain_reference_in_float64(weights):
    cfg, sd = weights
    model, spec = build_model(cfg, seg_upsample=False)
    load_state_dict(model.double(), sd)
    x = torch.rand((2, 3, IMGSZ, IMGSZ), generator=torch.Generator()
                   .manual_seed(9), dtype=torch.float64)
    with torch.no_grad():
        (dec, feats), seg = model(x)
        ref_dec, ref_seg = R.forward(cfg, sd, x)
    assert dec.shape == ref_dec.shape == (2, ANCHORS_256, 5 + 6)
    assert [f.shape[2:4] for f in feats] == [(32, 32), (16, 16), (8, 8),
                                             (4, 4)]
    # the port decodes in float32: within a few of its roundings of each
    # value (boxes in pixels, scores in (0, 1))
    eps = torch.finfo(torch.float32).eps
    assert bool(((dec - ref_dec).abs()
                 <= 8 * eps * ref_dec.abs().clamp(min=1.0)).all())
    assert seg.shape == ref_seg.shape == (2, 3, IMGSZ // 8, IMGSZ // 8)
    assert ((seg - ref_seg).abs().max()
            <= 1e-9 * ref_seg.abs().max())
    # activations survive the depth: the seg logits are not a constant
    assert float(ref_seg.std()) > 1e-3


@pytest.fixture(scope="module")
def predictor(weights):
    cfg, sd = weights
    return Predictor(cfg, {k: v.float() for k, v in sd.items()},
                     imgsz=IMGSZ, half=False, device="cpu",
                     conf_thres=0.01)


def test_run_batch_and_call_on_a_16_9_frame(predictor):
    rng = np.random.default_rng(3)
    frame = rng.integers(0, 256, (144, 256, 3), dtype=np.uint8)  # 16:9 BGR
    det = predictor(frame)
    assert det.masks[0].shape == (144, 256)
    assert det.xyxy[0].shape[1] == 6
    canvas = np.full((1, IMGSZ, IMGSZ, 3), 114, np.uint8)
    canvas[0, 56:200] = frame[:, :, ::-1]  # the letterbox, gain 1
    boxes, scores, classes, num, seg = predictor.run_batch(canvas)
    assert seg.shape == (1, IMGSZ, IMGSZ) and boxes.shape[1] == 300
    np.testing.assert_array_equal(det.masks[0], seg[0, 56:200])
    n = int(num[0])
    assert n == len(det.xyxy[0]) > 0
    np.testing.assert_allclose(det.xyxy[0][:, 4], scores[0, :n], rtol=1e-6)
    np.testing.assert_allclose(det.xyxy[0][:, [1, 3]],
                               np.clip(boxes[0, :n, [1, 3]].T - 56, 0, 144),
                               atol=1e-3)


@pytest.mark.parametrize("cfg,imgsz,stride", [
    (tiny_x6, 352, 64), (tiny_x6, 96, 64), (tiny_cfg, 80, 32)])
def test_predictor_refuses_an_imgsz_off_the_largest_stride(cfg, imgsz,
                                                           stride):
    model, _ = build_model(cfg())
    with pytest.raises(ValueError, match=f"imgsz {imgsz} .* {stride}"):
        Predictor(cfg(), model.state_dict(), imgsz=imgsz, half=False,
                  device="cpu")


def test_level_balance_is_v5_0s():
    # YOLOv5 v5.0 loss.py: {3: [4.0, 1.0, 0.4]}.get(nl, [4.0, 1.0, 0.25,
    # 0.06, .02])
    assert level_balance(3) == (4.0, 1.0, 0.4)
    assert level_balance(4) == (4.0, 1.0, 0.25, 0.06)
    assert level_balance(5) == (4.0, 1.0, 0.25, 0.06, 0.02)
    _, spec = build_model(tiny_x6())
    det_loss, _, _ = loss_and_schedule(load_hyp(), spec, IMGSZ, 10)
    assert det_loss.balance == (4.0, 1.0, 0.25, 0.06)
    with pytest.raises(ValueError, match="4 levels"):
        DetectionLoss(anchors=det_loss.anchors, nc=6, balance=(1.0,) * 3)


def test_objectness_is_the_balanced_sum_of_its_levels():
    _, spec = build_model(tiny_x6())
    det_loss, _, _ = loss_and_schedule(load_hyp(), spec, IMGSZ, 10)
    g = torch.Generator().manual_seed(4)
    preds = [torch.randn((2, 3, IMGSZ // s, IMGSZ // s, 11), generator=g)
             for s in spec.det_strides]
    b = train_batch(np.random.default_rng(1), 2, IMGSZ, 6, 5)
    tg = torch.from_numpy(b["det_targets"])
    mask = torch.from_numpy(b["det_mask"])
    lobj = det_loss(preds, tg, mask)[1][1]
    per_level = []
    for i in range(4):
        one = tuple(float(i == j) for j in range(4))
        loss = DetectionLoss(**{**det_loss.__dict__, "balance": one})
        per_level.append(float(loss(preds, tg, mask)[1][1]))
    want = sum(w * t for w, t in zip((4.0, 1.0, 0.25, 0.06), per_level))
    assert float(lobj) == pytest.approx(want, rel=1e-6)


def test_four_level_train_step_check_anchors_and_validator(weights):
    cfg, sd = weights
    torch.manual_seed(0)
    model, spec = build_model(cfg, seg_upsample=False, train=True)
    load_state_dict(model, {k: v.float() for k, v in sd.items()})
    det_loss, opt_cfg, lf = loss_and_schedule(load_hyp(), spec, IMGSZ, 10)
    state = create_train_state(model, opt_cfg)
    step = make_train_step(model, det_loss, opt_cfg, lf, nb=4,
                           warmup_iters=4, nominal_bs=2, batch_size=2,
                           fused_seg=True)
    b = train_batch(np.random.default_rng(2), 2, IMGSZ, 6, 8)
    start = {k: v.detach().clone() for k, v in state.params.items()}
    for _ in range(2):
        state, m = step(state, b)
        assert np.isfinite(float(m["loss"])) and m["stepped"] == 1
    moved = [k for k, v in state.params.items()
             if not torch.equal(v, start[k])]
    assert any(k.startswith("model.34.m.3.") for k in moved)  # the P6 conv

    anchors = np.asarray(spec.layers[34].args[1], np.float32).reshape(4, 3, 2)
    labels = [np.array([[0, 0.5, 0.5, 0.6, 0.7], [1, 0.3, 0.3, 0.05, 0.08]],
                       np.float32)] * 4
    ds = types.SimpleNamespace(shapes=np.full((4, 2), IMGSZ), det_labels=labels)
    out, _ = check_anchors(ds, anchors, spec.det_strides, imgsz=IMGSZ)
    assert out.shape == (4, 3, 2)

    model.eval()
    vmodel, _ = build_model(cfg)
    vmodel.load_state_dict(model.state_dict())
    batch = {"image": b["image"], "det_targets": b["det_targets"],
             "det_mask": b["det_mask"], "seg_labels": b["seg_labels"],
             "shapes": [None, None]}
    got = Validator(vmodel.eval(), nc=6, se_nc=3).run([batch])
    assert got["seen"] == 2 and 0.0 <= got["miou"] <= 1.0
