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


# ---- the kernel's ordered path (compact, sort once, walk) in PyTorch ops ----

def assert_ordered_matches(planes, max_det, iou=0.45, chunk=32, surv=16):
    """greedy_select_ordered_plain == greedy_select_plain == the JAX kernel
    (interpret mode) on six (B, A) planes, A a multiple of 128."""
    from desenet_tpu.ops.nms_fused import LANES, _run_kernel
    from desenet_tpu_torch.ops.nms_fused import (greedy_select_ordered_plain,
                                                 greedy_select_plain)

    want = greedy_select_plain(*planes, max_det, iou)
    got = greedy_select_ordered_plain(*planes, max_det, iou, chunk, surv)
    assert torch.equal(got, want)
    b, a = planes[4].shape
    jp = [jnp.asarray(p.numpy().reshape(b, a // LANES, LANES)) for p in planes]
    jout = np.asarray(_run_kernel(jp, max_det, iou, interpret=True))[..., :6]
    np.testing.assert_array_equal(got.numpy(), jout)
    return got


# (live, max_det, generator arguments) at A 512, walked in rounds of 32 with
# 16 survivors settled a round (the kernel's 1024 and 512, scaled down)
ORDERED_CASES = [
    (200, 64, {}),
    (200, 64, {"levels": 5}),                 # many tied scores
    (200, 64, {"dup": 0.5}),                  # exact duplicate boxes
    (300, 64, {"dup": 0.9, "levels": 3}),
    (0, 16, {}),                              # all dead
    (1, 16, {}),
    (20, 64, {"spread": 300.0}),              # fewer live than max_det
    (400, 24, {}),                            # more kept than max_det
    (512, 64, {"spread": 300.0}),             # every anchor a candidate
    (32, 64, {}), (33, 64, {}), (16, 64, {}), (17, 64, {}),  # round boundaries
]


@pytest.mark.parametrize("live,max_det,kw", ORDERED_CASES)
def test_ordered_select_matches_plain_and_jax(live, max_det, kw):
    from desenet_tpu_torch.testing import select_planes

    planes = select_planes(np.random.default_rng(live + max_det), 2, 512, live,
                           **kw)
    assert (planes[4] > 0).sum(1).tolist() == [live, live]
    out = assert_ordered_matches(planes, max_det)
    picks = (out[..., 4] > 0).sum(1)
    assert int(picks.max()) <= min(live, max_det)
    assert int(picks.min()) > 0 or live == 0


@pytest.mark.parametrize("chunk,surv", [(1024, 512), (64, 64), (8, 3), (5, 1)])
def test_ordered_select_at_other_round_sizes(chunk, surv):
    from desenet_tpu_torch.testing import select_planes

    planes = select_planes(np.random.default_rng(20), 2, 384, 300, levels=11,
                           dup=0.3, spread=600.0)
    assert_ordered_matches(planes, 48, 0.5, chunk, surv)


def test_ordered_select_on_a_dense_decode():
    """A small dense decode: one pick an object, through the prep, against
    the JAX function."""
    from desenet_tpu_torch.ops.nms_fused import greedy_select_ordered_plain
    from desenet_tpu_torch.testing import dense_decode

    pred = dense_decode(np.random.default_rng(21), 2, 1024, 6, 300, 12)
    _, _, _, valid = assert_same(pred, conf_thres=0.25, iou_thres=0.45,
                                 max_det=64)
    assert valid.sum(1).tolist() == [12, 12]
    planes = nms_planes(torch.from_numpy(pred), 0.25)
    assert (planes[4] > 0).sum(1).tolist() == [300, 300]
    got = greedy_select_ordered_plain(*planes, 64, 0.45, 64, 16)
    assert torch.equal(got, greedy_select(*planes, 64, 0.45))


def test_ordered_select_property():
    """Any small set of planes, any round and survivor size: the ordered
    path's rows are the argmax loop's."""
    hypothesis = pytest.importorskip("hypothesis")
    st = hypothesis.strategies
    from desenet_tpu_torch.ops.nms_fused import (greedy_select_ordered_plain,
                                                 greedy_select_plain)

    @hypothesis.settings(max_examples=40, deadline=None)
    @hypothesis.given(st.data())
    def select(data):
        a = data.draw(st.integers(1, 24))
        grid = st.integers(0, 6)  # coarse coordinates: overlaps, ties abound
        xy = data.draw(st.lists(st.tuples(grid, grid, st.integers(1, 4),
                                          st.integers(1, 4)), min_size=a,
                                max_size=a))
        # 0 is a dead anchor (-1), 1..5 are scores that tie often
        sc = data.draw(st.lists(st.integers(0, 5), min_size=a, max_size=a))
        cl = data.draw(st.lists(st.integers(0, 1), min_size=a, max_size=a))
        cls = torch.tensor(cl, dtype=torch.float32)[None]
        box = torch.tensor([[x, y, x + w, y + h] for x, y, w, h in xy],
                           dtype=torch.float32)[None] * 10 + cls[..., None] * 4096
        score = torch.tensor([s / 8 if s else -1.0 for s in sc])[None]
        planes = [box[..., i].contiguous() for i in range(4)] + [score, cls]
        iou = data.draw(st.sampled_from([0.0, 0.3, 0.45]))
        max_det = data.draw(st.integers(1, 30))
        chunk = data.draw(st.integers(1, 12))
        surv = data.draw(st.integers(1, chunk))
        want = greedy_select_plain(*planes, max_det, iou)
        got = greedy_select_ordered_plain(*planes, max_det, iou, chunk, surv)
        assert torch.equal(got, want)

    select()


def test_path_constants_are_the_sources():
    """The caps the wrapper states are the ones the CUDA sources hold."""
    import os
    import re

    from desenet_tpu_torch.ops import _ext, nms_fused, nms_pallas

    def constants(name):
        with open(os.path.join(_ext.CSRC, name)) as fh:
            return dict(re.findall(r"constexpr int (\w+) = (\w+);", fh.read()))

    walk, fused = constants("nms_walk.cuh"), constants("nms_fused.cu")
    assert int(walk["kThreads"]) == nms_pallas.CHUNK
    assert int(walk["kSurv"]) == nms_pallas.SURV
    assert int(walk["kKeptCap"]) == nms_pallas.KEPT_CAP == nms_fused.KEPT_CAP
    assert int(walk["kLoopCap"]) == nms_pallas.SMEM_CAP == nms_fused.LOOP_CAP
    assert int(fused["kCandCap"]) == nms_fused.CAND_CAP
    # the ordered path's shared memory fits a block's 227 KB: the walk's
    # struct, then a key (8 B), a box (16 B) and a class (4 B) a candidate
    walk_bytes = (nms_pallas.KEPT_CAP * 20 + nms_pallas.SURV * 24
                  + nms_pallas.SURV * nms_pallas.SURV // 8
                  + nms_pallas.SURV // 8)
    assert walk_bytes + nms_fused.CAND_CAP * 28 <= 232448 - 1024


@pytest.mark.parametrize("fn", ["desenet_nms_fused", "desenet_seg_tail"])
def test_served_kernels_ctypes_signatures(fn):
    """The two redesigned entry points' argument lists in ops/_ext.py against
    their sources, pointer for pointer: ctypes passes an undeclared argument
    as a 32-bit int and would cut a pointer."""
    import ctypes
    import os
    import re

    from desenet_tpu_torch.ops import _ext

    name = {"desenet_nms_fused": "nms_fused.cu",
            "desenet_seg_tail": "seg_tail.cu"}[fn]
    with open(os.path.join(_ext.CSRC, name)) as fh:
        args = re.search(r'extern "C" int %s\(([^)]*)\)' % fn, fh.read())[1]
    args = [a.strip() for a in args.split(",")]
    sig = _ext._SIGNATURES[fn]
    assert len(sig) == len(args)
    for a, t in zip(args, sig):
        want = (ctypes.c_void_p if "*" in a else
                ctypes.c_float if a.startswith("float") else ctypes.c_int)
        assert t is want, a
    assert any("paths" in a or "seg" in a for a in args)
