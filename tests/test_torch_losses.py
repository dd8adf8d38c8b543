"""desenet_tpu_torch.losses and ops.boxes.bbox_iou against the reference's
golden detection loss and against the JAX package on the same inputs
(numpy, seeded), values and gradients; the bundled hyperparameters against
the JAX package's YAML.

Bars: the detection loss within 1e-5 relative and its gradients within
1e-5 of their largest magnitude (f32 on the CPU on both sides); the golden
at tests/test_losses.py's bars."""

import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import yaml

from desenet_tpu.losses import DetectionLoss as JDetectionLoss
from desenet_tpu.losses import detection as jdet
from desenet_tpu.losses import segmentation_loss as jax_segmentation_loss
from desenet_tpu.ops.boxes import bbox_iou as jax_bbox_iou
from desenet_tpu_torch.losses import DetectionLoss, segmentation_loss
from desenet_tpu_torch.losses import detection as pdet
from desenet_tpu_torch.ops.boxes import bbox_iou
from desenet_tpu_torch.train import engine

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
ANCHORS = (((1.25, 1.625), (2.0, 3.75), (4.125, 2.875)),
           ((1.875, 3.8125), (3.875, 2.8125), (3.6875, 7.4375)),
           ((3.625, 2.8125), (4.875, 6.1875), (11.65625, 10.1875)))


def pad_targets(tg, batch, max_t=32):
    """(n,6) [img,cls,xywh] -> padded (B, M, 5) + mask."""
    out = np.zeros((batch, max_t, 5), np.float32)
    mask = np.zeros((batch, max_t), bool)
    for b in range(batch):
        rows = tg[tg[:, 0] == b][:, 1:6]
        out[b, : len(rows)] = rows
        mask[b, : len(rows)] = True
    return out, mask


def test_detection_loss_matches_reference_golden():
    z = np.load(os.path.join(HERE, "goldens", "det_loss.npz"))
    preds = [torch.from_numpy(z[f"p{i}"]) for i in range(3)]
    anchors = tuple(tuple(tuple(float(v) for v in a) for a in scale)
                    for scale in z["anchors"])
    tg, mask = pad_targets(z["targets"], batch=4)
    total, (lbox, lobj, lcls) = DetectionLoss(anchors=anchors, nc=3)(
        preds, torch.from_numpy(tg), torch.from_numpy(mask))
    np.testing.assert_allclose(float(lbox), z["comps"][0], rtol=2e-5, atol=1e-6)
    # the reference keeps an arbitrary writer where targets collide on this
    # 2x2-grid golden, the port (like the JAX package) the larger IoU
    np.testing.assert_allclose(float(lobj), z["comps"][1], rtol=5e-4)
    np.testing.assert_allclose(float(lcls), z["comps"][2], rtol=2e-5, atol=1e-6)
    np.testing.assert_allclose(float(total), float(z["total"]), rtol=5e-4)


def det_case(name):
    """preds (B, na, ny, nx, 8) per scale, targets, mask, loss kwargs."""
    rng = np.random.default_rng(7)
    b, m = 2, 6
    preds = [rng.standard_normal((b, 3, s, s, 8)).astype(np.float32)
             for s in (8, 4, 2)]
    tg = np.zeros((b, m, 5), np.float32)
    mask = np.zeros((b, m), bool)
    kw = {}
    if name != "no_targets":
        n = 4
        tg[:, :n, 0] = rng.integers(0, 3, (b, n))
        tg[:, :n, 1:3] = rng.uniform(0.1, 0.9, (b, n, 2))
        tg[:, :n, 3:5] = rng.uniform(0.05, 0.5, (b, n, 2))
        mask[:, :n] = True
    if name == "focal":
        kw = dict(fl_gamma=1.5)
    elif name == "label_smoothing":
        kw = dict(label_smoothing=0.1, cls_pw=1.3, obj_pw=0.8)
    elif name == "shared_cell":
        # two targets of different sizes whose centres fall in one cell and
        # both match anchor 0: they claim one (cell, anchor), where the
        # objectness target is the larger IoU
        tg[0, 4] = [1, 0.30, 0.30, 0.10, 0.12]
        tg[0, 5] = [2, 0.31, 0.31, 0.13, 0.15]
        mask[0, 4:6] = True
    return preds, tg, mask, kw


@pytest.mark.parametrize("name", ["plain", "focal", "label_smoothing",
                                  "no_targets", "shared_cell"])
def test_detection_loss_matches_jax(name):
    preds, tg, mask, kw = det_case(name)
    jloss = JDetectionLoss(anchors=ANCHORS, nc=3, **kw)

    def jfn(ps):
        total, comps = jloss(ps, jnp.asarray(tg), jnp.asarray(mask))
        return total, comps

    (jtotal, jcomps), jgrads = jax.value_and_grad(jfn, has_aux=True)(
        [jnp.asarray(p) for p in preds])
    pt = [torch.from_numpy(p).requires_grad_(True) for p in preds]
    total, comps = DetectionLoss(anchors=ANCHORS, nc=3, **kw)(
        pt, torch.from_numpy(tg), torch.from_numpy(mask))
    total.backward()
    for got, want in zip([total, *comps], [jtotal, *jcomps]):
        np.testing.assert_allclose(float(got.detach()), float(want),
                                   rtol=1e-5, atol=1e-7)
    if name == "no_targets":
        assert float(comps[0]) == 0.0 and float(comps[2]) == 0.0
    for p, g in zip(pt, jgrads):
        g = np.asarray(g)
        assert np.abs(p.grad.numpy() - g).max() <= 1e-5 * np.abs(g).max()


def test_objectness_target_is_the_larger_iou():
    """A scatter-max onto the (cell, anchor) that two targets claim: the
    objectness loss does not depend on the targets' order (a last write
    would), and equals the loss with one of the two alone."""
    preds, tg, mask, _ = det_case("shared_cell")
    loss = DetectionLoss(anchors=ANCHORS, nc=3, box_gain=0.0, cls_gain=0.0)
    pt = [torch.from_numpy(p) for p in preds]

    def lobj(t, m):
        return float(loss(pt, torch.from_numpy(t), torch.from_numpy(m))[1][1])

    both = lobj(tg, mask)
    swapped = tg.copy()
    swapped[0, [4, 5]] = tg[0, [5, 4]]
    assert lobj(swapped, mask) == both
    alone = []
    for drop in (4, 5):
        m = mask.copy()
        m[0, drop] = False
        alone.append(lobj(tg, m))
    assert alone[0] != alone[1]
    assert both in [pytest.approx(a, rel=1e-6) for a in alone]


@pytest.mark.parametrize("fn", ["bce_with_logits", "focal_bce_with_logits",
                                "qfocal_bce_with_logits",
                                "bce_blur_with_logits"])
def test_bce_variants_match_jax(fn):
    rng = np.random.default_rng(3)
    x = rng.normal(0, 3, (64,)).astype(np.float32)
    t = rng.uniform(0, 1, (64,)).astype(np.float32)
    args = (1.5,) if "focal" in fn else ()
    want = np.asarray(getattr(jdet, fn)(jnp.asarray(x), jnp.asarray(t),
                                        *args))
    got = getattr(pdet, fn)(torch.from_numpy(x), torch.from_numpy(t),
                            *args).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-7)


def boxes(seed, n=256):
    rng = np.random.default_rng(seed)
    xy = rng.uniform(0, 4, (2, n, 2))
    wh = rng.uniform(0.2, 3, (2, n, 2))
    b1, b2 = (np.concatenate([xy[i], wh[i]], -1).astype(np.float32)
              for i in range(2))
    # pairs whose x-overlap is exactly zero: touching edges, where the
    # clip's gradient is half (jnp.clip / torch.maximum), not whole
    b2[:8, 0] = b1[:8, 0] + (b1[:8, 2] + b2[:8, 2]) / 2
    b1[:8] = np.round(b1[:8] * 4) / 4
    b2[:8] = np.round(b2[:8] * 4) / 4
    b2[:8, 0] = b1[:8, 0] + (b1[:8, 2] + b2[:8, 2]) / 2
    return b1, b2


@pytest.mark.parametrize("kind", ["IoU", "GIoU", "DIoU", "CIoU"])
@pytest.mark.parametrize("xyxy", [False, True])
def test_bbox_iou_matches_jax(kind, xyxy):
    b1, b2 = boxes(11)
    if xyxy:
        b1 = np.concatenate([b1[:, :2], b1[:, :2] + b1[:, 2:]], -1)
        b2 = np.concatenate([b2[:, :2], b2[:, :2] + b2[:, 2:]], -1)
    kw = {kind: True} if kind != "IoU" else {}
    (want, (g1, g2)) = jax.value_and_grad(
        lambda a, b: jax_bbox_iou(a, b, x1y1x2y2=xyxy, **kw).sum(),
        argnums=(0, 1))(jnp.asarray(b1), jnp.asarray(b2))
    v1 = jax_bbox_iou(jnp.asarray(b1), jnp.asarray(b2), x1y1x2y2=xyxy, **kw)
    t1 = torch.from_numpy(b1).requires_grad_(True)
    t2 = torch.from_numpy(b2).requires_grad_(True)
    got = bbox_iou(t1, t2, x1y1x2y2=xyxy, **kw)
    got.sum().backward()
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(v1),
                               rtol=1e-5, atol=1e-6)
    for t, g in ((t1, g1), (t2, g2)):
        g = np.asarray(g)
        assert np.abs(t.grad.numpy() - g).max() <= 1e-5 * np.abs(g).max()


def test_bbox_iou_boundary_gradient_is_half():
    """Boxes that touch: d inter / d overlap is half the other side's
    extent, as jnp.clip's gradient at 0 gives (clamp would give all)."""
    a = torch.tensor([[0.0, 0.0, 1.0, 1.0]], requires_grad=True)
    b = torch.tensor([[1.0, 0.0, 2.0, 1.0]])
    bbox_iou(a, b).sum().backward()
    g = jax.grad(lambda v: jax_bbox_iou(v, jnp.asarray(b.numpy())).sum())(
        jnp.asarray(a.detach().numpy()))
    np.testing.assert_allclose(a.grad.numpy(), np.asarray(g), rtol=1e-6)
    assert float(a.grad[0, 2]) != 0.0


def seg_inputs(n_out, ignore=False):
    rng = np.random.default_rng(5)
    ps = [rng.standard_normal((2, 4, 8, 8)).astype(np.float32)
          for _ in range(n_out)]
    y = rng.integers(0, 4, (2, 8, 8)).astype(np.int32)
    if ignore:
        y[0, :3] = -1
    return ps, y


@pytest.mark.parametrize("n_out", [0, 1, 2, 3])
@pytest.mark.parametrize("extra", ["plain", "ignore", "class_weight"])
def test_segmentation_loss_matches_jax(n_out, extra):
    """0: a bare tensor; 1-3: a list of outputs (the aux-count dispatch)."""
    ps, y = seg_inputs(max(n_out, 1), ignore=extra == "ignore")
    cw = [1.0, 2.0, 0.5, 1.5] if extra == "class_weight" else None
    jps = [jnp.asarray(np.transpose(p, (0, 2, 3, 1))) for p in ps]
    tps = [torch.from_numpy(p).requires_grad_(True) for p in ps]
    jarg, targ = (jps[0], tps[0]) if n_out == 0 else (jps, tps)
    want, jg = jax.value_and_grad(lambda a: jax_segmentation_loss(
        a, jnp.asarray(y), 0.1, -1,
        None if cw is None else jnp.asarray(cw)))(jarg)
    got = segmentation_loss(targ, torch.from_numpy(y), 0.1, -1, cw)
    got.backward()
    np.testing.assert_allclose(float(got.detach()), float(want), rtol=1e-6)
    jg = [jg] if n_out == 0 else jg
    for t, g in zip(tps, jg):
        g = np.transpose(np.asarray(g), (0, 3, 1, 2))
        assert np.abs(t.grad.numpy() - g).max() <= 1e-5 * np.abs(g).max()


def test_hyp_json_equals_the_yaml():
    with open(os.path.join(ROOT, "desenet_tpu", "configs",
                           "hyp_scratch.yaml")) as fh:
        want = yaml.safe_load(fh)
    with open(engine.HYP_PATH) as fh:
        assert json.load(fh) == want
    assert engine.load_hyp() == want


@pytest.mark.parametrize("imgsz,linear,adam", [(640, False, False),
                                               (320, True, True)])
def test_loss_and_schedule_match_the_engine(imgsz, linear, adam):
    """desenet_tpu/train/engine.py:366-394 on yolov5s_seg: the loss gains
    scaled by the number of scales, the classes and the image size, the
    anchors in grid units, the optimizer's fields and the LR lambda."""
    from desenet_tpu.models.build import parse_config
    from desenet_tpu.models.heads import Detect
    from desenet_tpu.train import schedule as jsched
    from desenet_tpu_torch.models import build_model, config_path

    hyp = engine.load_hyp()
    _, spec = build_model(config_path("yolov5s_seg"))
    det, opt, lf = engine.loss_and_schedule(hyp, spec, imgsz, 30, linear,
                                            adam=adam, label_smoothing=0.1)
    jspec = parse_config(os.path.join(ROOT, "desenet_tpu", "models",
                                      "configs", "yolov5s_seg.yaml"))
    nl, nc = len(jspec.det_strides), jspec.de_nc
    head = Detect(nc=nc, anchors=jspec.layers[jspec.det_layer].args[1],
                  strides=jspec.det_strides)
    assert det.anchors == tuple(tuple(tuple(float(v) for v in a) for a in s)
                                for s in head.anchors_grid_units())
    assert det.nc == nc == spec.de_nc
    assert det.box_gain == hyp["box"] * 3.0 / nl
    assert det.cls_gain == hyp["cls"] * nc / 80.0 * 3.0 / nl
    assert det.obj_gain == hyp["obj"] * (imgsz / 640.0) ** 2 * 3.0 / nl
    assert (det.cls_pw, det.obj_pw, det.fl_gamma, det.anchor_t,
            det.label_smoothing) == (hyp["cls_pw"], hyp["obj_pw"],
                                     hyp["fl_gamma"], hyp["anchor_t"], 0.1)
    assert (opt.optimizer, opt.lr0, opt.momentum, opt.weight_decay,
            opt.warmup_bias_lr, opt.warmup_momentum) == (
        "adam" if adam else "sgd", hyp["lr0"], hyp["momentum"],
        hyp["weight_decay"], hyp["warmup_bias_lr"], hyp["warmup_momentum"])
    jlf = (jsched.linear_lr(hyp["lrf"], 30) if linear
           else jsched.one_cycle(1.0, hyp["lrf"], 30))
    for epoch in (0, 7, 29):
        np.testing.assert_array_max_ulp(lf(np.float32(epoch)),
                                        np.float32(jlf(jnp.float32(epoch))), 1)
