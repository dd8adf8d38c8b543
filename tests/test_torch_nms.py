"""Port fused_select_nms (plain PyTorch selection, the CPU path) vs the JAX
fused_select_nms with its Pallas kernel in interpret mode, on the synthetic
decodes of tests/test_nms_fused.py. Same valid count and classes, scores at
1e-6, boxes at atol 1e-3 (both run the same f32 formula; the tolerances
are those the JAX kernel is held to against its oracle)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from desenet_tpu.ops.nms_fused import fused_select_nms as jax_fused
from desenet_tpu_torch.ops.nms import non_max_suppression
from desenet_tpu_torch.ops.nms_fused import (fused_select_nms, greedy_select,
                                             nms_planes)


def make_pred(rng, b=3, a=512, nc=6, dense=False):
    """Synthetic (B, A, 5+nc) decode: xywh pixel boxes + obj + cls."""
    cxy = rng.uniform(50, 600, (b, a, 2)).astype(np.float32)
    wh = rng.uniform(10, 120, (b, a, 2)).astype(np.float32)
    obj = rng.uniform(0, 1, (b, a, 1)).astype(np.float32)
    if not dense:
        obj[obj < 0.6] *= 0.05  # sparsify: most below conf
    cls = rng.uniform(0, 1, (b, a, nc)).astype(np.float32)
    return np.concatenate([cxy, wh, obj, cls], axis=-1)


def assert_same(pred, **kw):
    want = [np.asarray(v) for v in
            jax_fused(jnp.asarray(pred), interpret=True, **kw)]
    got = [v.numpy() for v in fused_select_nms(torch.from_numpy(pred), **kw)]
    jb, js, jc, jv = want
    tb, ts, tc, tv = got
    np.testing.assert_array_equal(tv.sum(1), jv.sum(1))
    np.testing.assert_array_equal(tv, jv)
    np.testing.assert_array_equal(tc, jc)
    np.testing.assert_allclose(ts, js, rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(tb, jb, rtol=1e-5, atol=1e-3)
    return got


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_matches_jax_kernel(seed):
    pred = make_pred(np.random.default_rng(seed))
    _, _, _, valid = assert_same(pred, conf_thres=0.25, iou_thres=0.45,
                                 max_det=64)
    assert valid.sum() > 0


def test_dense_scene_capped_by_max_det():
    pred = make_pred(np.random.default_rng(3), a=1024, dense=True)
    _, _, _, valid = assert_same(pred, conf_thres=0.25, iou_thres=0.45,
                                 max_det=32)
    assert valid.sum(1).max() == 32


def test_empty_scene():
    pred = make_pred(np.random.default_rng(4))
    pred[..., 4] = 0.0  # no candidate above conf
    boxes, scores, cls, valid = assert_same(pred, conf_thres=0.25,
                                            iou_thres=0.45, max_det=16)
    assert valid.sum() == 0
    assert np.all(boxes == 0) and np.all(scores == 0) and np.all(cls == -1)


@pytest.mark.parametrize("kw", [{"agnostic": True}, {"classes": (1, 3)}])
def test_agnostic_and_classes(kw):
    pred = make_pred(np.random.default_rng(5), dense=True)
    _, _, cls, valid = assert_same(pred, conf_thres=0.25, iou_thres=0.45,
                                   max_det=32, **kw)
    if "classes" in kw:
        assert set(np.unique(cls[valid])) <= {1.0, 3.0}


def test_front_end_counts_and_refuses_unported_modes():
    pred = torch.from_numpy(make_pred(np.random.default_rng(6)))
    out = non_max_suppression(pred, conf_thres=0.25, iou_thres=0.45,
                              max_det=16)
    assert out.boxes.shape == (3, 16, 4)
    assert out.num.dtype == torch.int32
    assert torch.equal(out.num, out.valid.sum(1).int())
    # multi-label and per-scale lists take the top-k + greedy-NMS route
    # (tests/test_torch_nms_val.py holds it against JAX)
    for kw in (dict(prediction=pred, multi_label=True),
               dict(prediction=[pred])):
        got = non_max_suppression(conf_thres=0.25, iou_thres=0.45,
                                  max_det=16, **kw)
        assert got.boxes.shape == (3, 16, 4)
        assert torch.equal(got.num, got.valid.sum(1).int())
    # the single-label list is the one-array result
    lst = non_max_suppression([pred], conf_thres=0.25, iou_thres=0.45,
                              max_det=16)
    assert torch.equal(lst.num, out.num)
    # a device that is neither CPU nor CUDA is refused, never computed
    with pytest.raises(ValueError, match="CPU or CUDA"):
        non_max_suppression(pred.to("meta"), multi_label=True)


def test_greedy_select_checks_its_inputs():
    planes = nms_planes(torch.from_numpy(make_pred(np.random.default_rng(7))),
                        0.25)
    with pytest.raises(ValueError, match="float32"):
        greedy_select(*planes[:5], planes[5].double(), 8, 0.45)
    with pytest.raises(ValueError, match="shape"):
        greedy_select(*planes[:5], planes[5][:, :10].contiguous(), 8, 0.45)
    # neither CPU nor CUDA: refused, never silently computed
    meta = [p.to("meta") for p in planes]
    with pytest.raises(ValueError, match="CPU or CUDA"):
        greedy_select(*meta, 8, 0.45)


def test_box_geometry_matches_jax():
    from desenet_tpu.ops import boxes as jax_boxes
    from desenet_tpu_torch.ops.boxes import box_iou, xywh2xyxy

    xywh = make_pred(np.random.default_rng(8), b=1, a=64)[0, :, :4]
    xyxy = np.array(jax_boxes.xywh2xyxy(jnp.asarray(xywh)))  # writable
    got = xywh2xyxy(torch.from_numpy(xywh)).numpy()
    np.testing.assert_allclose(got, xyxy, rtol=0, atol=1e-4)
    want = np.asarray(jax_boxes.box_iou(jnp.asarray(xyxy[:40]),
                                        jnp.asarray(xyxy[24:])))
    got = box_iou(torch.from_numpy(xyxy[:40]), torch.from_numpy(xyxy[24:]))
    assert got.shape == (40, 40)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-6)
