"""YOLOv5 v7.0's instance-segmentation model (``yolov5x_v7seg``: the
``Segment`` head with ``Proto``) on the CPU, at a tiny size.

- The port's forward against the benchmark's plain reference
  (``benchmark/reference/v7seg.py``, which imports nothing of the
  program) in float64 on the benchmark's seeded weights at width 0.25,
  depth 0.33, 128 px, nc 80, nm 32: the decode's 5 + nc columns, the raw
  coefficients and the prototypes; the served masks against the
  reference's (``mask_gap``).
- K1's kept indices point at the decode rows whose boxes and scores it
  served; with ``return_index`` DeSeNet's rows do not change, and
  ``nms_planes`` scores only the ``nc`` class columns.
- The full-width config: 88.77 M parameters (BN folded) and 265.6 GFLOP
  at 640, v7.0's published model.
- The plain mask assembly on hand-made cases: box edges on and off whole
  proto pixels, bit order, rows past ``num``.
- ``Predictor.run_batch`` and ``__call__``, the spans and counters, the
  fp8 control reaching Proto, and the programs that refuse the model.
"""

import json

import numpy as np
import pytest
import torch

from benchmark.counts.v7seg import forward_flops
from benchmark.harness.weights_v7seg import seeded_weights
from benchmark.reference import v7seg as R
from benchmark.reference.instseg import mask_gap_one
from desenet_tpu_torch.api import Predictor
from desenet_tpu_torch.eval.validator import Validator
from desenet_tpu_torch.models import (build_model, config_path,
                                      mask_coefficients)
from desenet_tpu_torch.ops import mask_assembly as M
from desenet_tpu_torch.ops import nms_fused
from desenet_tpu_torch.ops.boxes import xywh2xyxy
from desenet_tpu_torch.testing import (MASK_CASES, mask_assembly_case,
                                       nms_fused_case, NMS_FUSED_CASES,
                                       synthetic_decode)
from desenet_tpu_torch.utils import profiling
from desenet_tpu_torch.utils.convert import load_state_dict

IMGSZ = 128
NC, NM = 80, 32
ANCHORS = 3 * sum((IMGSZ // s) ** 2 for s in (8, 16, 32))  # 1008


def shipped() -> dict:
    with open(config_path("yolov5x_v7seg")) as fh:
        return json.load(fh)


def tiny_conf() -> dict:
    """The benchmark's configuration at width 0.25, depth 0.33, 128 px."""
    with open("benchmark/configs/yolov5x_v7seg.json") as fh:
        conf = json.load(fh)
    conf["model"].update(width_multiple=0.25, depth_multiple=0.33)
    conf.update(imgsz=IMGSZ, dtype="float32")
    conf["init"]["bn_calibration_frames"] = 2
    return conf


@pytest.fixture(scope="module")
def weights():
    """The benchmark's seeded weights (BN calibrated, about 100 NMS
    candidates a frame), under the names the port loads."""
    torch.set_num_threads(4)
    conf = tiny_conf()
    return conf["model"], seeded_weights(conf, 7, torch.device("cpu"))


@pytest.fixture(scope="module")
def frames():
    g = torch.Generator().manual_seed(3)
    return (torch.rand((2, IMGSZ, IMGSZ, 3), generator=g) * 255).round().to(
        torch.uint8).numpy()


@pytest.fixture(scope="module")
def predictor(weights):
    cfg, sd = weights
    return Predictor(cfg, sd, imgsz=IMGSZ, half=False, device="cpu")


def test_shipped_config_is_the_published_model():
    """88.77 M parameters with BN folded (conv weights and biases, a bias
    a BN channel) and 265.6 GFLOP at 640 (2 a multiply-add), within 0.5%:
    v7.0's yolov5x-seg (88.8 M, 265.7 GFLOPs published)."""
    with torch.device("meta"):
        model, spec = build_model(shipped())
    n = sum(m.weight.numel() + (0 if m.bias is None else m.bias.numel())
            for m in model.modules() if isinstance(m, torch.nn.Conv2d))
    n += sum(m.weight.numel() for m in model.modules()
             if isinstance(m, torch.nn.BatchNorm2d))
    assert n == pytest.approx(88.77e6, rel=1e-4)
    assert forward_flops(shipped(), 640, 640) == pytest.approx(265.6e9,
                                                               rel=5e-3)
    assert spec.det_layer == 24 and spec.seg_layer == -1
    assert spec.layers[24].args[2:] == (32, 320)  # nm, npr scaled by 1.25
    assert mask_coefficients(spec) == 32
    assert type(model.model[0]).__name__ == "ConvBnAct"
    conv = model.model[0].conv
    assert (conv.kernel_size, conv.stride, conv.padding) == ((6, 6), (2, 2),
                                                             (2, 2))
    assert model.model[0]._stem_shape_refusal() is None  # a served stem


def test_forward_matches_the_plain_reference_in_float64(weights):
    cfg, sd = weights
    model, _ = build_model(cfg, seg_upsample=False)
    sd64 = {k: v.double() for k, v in sd.items()}
    load_state_dict(model.double(), sd64)
    x = torch.rand((2, 3, IMGSZ, IMGSZ), generator=torch.Generator()
                   .manual_seed(9), dtype=torch.float64)
    with torch.no_grad():
        (dec, feats), proto = model(x)
        ref_dec, ref_proto = R.forward(cfg, sd64, x)
    assert dec.shape == ref_dec.shape == (2, ANCHORS, 5 + NC + NM)
    assert dec.dtype == torch.float32  # the port decodes in float32
    assert proto.shape == ref_proto.shape == (2, NM, IMGSZ // 4, IMGSZ // 4)
    # boxes in pixels and scores in (0, 1), each within a few float32
    # roundings of the float64 value (the decode's sigmoid and products
    # in float32)
    eps = torch.finfo(torch.float32).eps
    head = slice(0, 5 + NC)
    assert bool(((dec[..., head] - ref_dec[..., head]).abs()
                 <= 8 * eps * ref_dec[..., head].abs().clamp(min=1.0)).all())
    # the coefficients stay raw: one float32 rounding of the float64 logit
    coef, ref_coef = dec[..., 5 + NC:], ref_dec[..., 5 + NC:]
    assert bool(((coef - ref_coef).abs()
                 <= eps * ref_coef.abs().clamp(min=1e-30)).all())
    # the prototypes are float64 through and through: summation order only
    assert float((proto - ref_proto).abs().max()) \
        <= 1e-9 * float(ref_proto.abs().max())
    assert float(ref_proto.std()) > 1e-3 and float(ref_coef.std()) > 1e-2


def test_kept_indices_point_at_the_rows_served(weights, frames,
                                               predictor):
    """K1's anchors (the plain version on the CPU) are the decode rows of
    the boxes, scores and classes it served."""
    x = torch.from_numpy(frames).permute(0, 3, 1, 2).float() / 255
    with torch.no_grad():
        (dec, _), _ = predictor.model(x)
    boxes, scores, cls, valid, idx = nms_fused.fused_select_nms(
        dec, 0.25, 0.45, 300, nc=NC, return_index=True)
    assert int(valid.sum()) > 20
    for i in range(len(x)):
        n = int(valid[i].sum())
        assert bool(valid[i, :n].all()) and bool((idx[i, n:] == -1).all())
        rows = dec[i, idx[i, :n].long()]
        conf = rows[:, 5:5 + NC] * rows[:, 4:5]
        best, best_cls = conf.max(1)
        assert torch.equal(scores[i, :n], best)
        assert torch.equal(cls[i, :n], best_cls.float())
        # the class offset (cls * 4096) added and taken away in float32
        torch.testing.assert_close(boxes[i, :n], xywh2xyxy(rows[:, :4]),
                                   atol=0.05, rtol=0)


def test_nms_planes_score_only_the_class_columns():
    rng = np.random.default_rng(5)
    det = torch.from_numpy(synthetic_decode(rng, 2, 2000, 6, 0.05))
    coef = torch.randn((2, 2000, NM), generator=torch.Generator()
                       .manual_seed(1)) + 3.0  # would win every argmax
    seg = torch.cat([det, coef], -1)
    want = nms_fused.nms_planes(det, 0.25)
    for got in (nms_fused.nms_planes(seg, 0.25, nc=6),
                nms_fused.nms_planes(det, 0.25, nc=6)):
        assert all(torch.equal(a, b) for a, b in zip(got, want))


@pytest.mark.parametrize("case", [c for c in NMS_FUSED_CASES
                                  if c[0] in ("sparse decode", "dense decode",
                                              "many tied scores",
                                              "exact duplicate boxes")],
                         ids=lambda c: c[0])
def test_desenet_rows_do_not_change_with_the_index(case):
    """DeSeNet's K1 rows are the same bit for bit with and without the
    anchor index; the argmax loop's and the ordered walk's anchors agree."""
    _, _, _, max_det, _ = case
    planes = nms_fused_case(case)
    rows = nms_fused.greedy_select(*planes, max_det, 0.45)
    got, idx = nms_fused.greedy_select(*planes, max_det, 0.45,
                                       return_index=True)
    assert torch.equal(got, rows)
    ordered, ord_idx = nms_fused.greedy_select_ordered_plain(
        *planes, max_det, 0.45, return_index=True)
    assert torch.equal(ordered, rows) and torch.equal(ord_idx, idx)
    live = got[..., 4] > 0
    assert bool(((idx >= 0) == live).all())
    b = torch.arange(len(idx))[:, None].expand_as(idx)
    assert torch.equal(planes[4][b[live], idx[live].long()], got[..., 4][live])


def _v7_masks(proto, coef, boxes, img):
    """v7.0's process_mask(upsample=False) as written: sigmoid, crop_mask
    on the boxes scaled by mw / iw, gt_(0.5); (n, hp, wp) bool."""
    hp, wp = proto.shape[1:]
    m = (coef @ proto.reshape(proto.shape[0], -1)).sigmoid().view(-1, hp, wp)
    d = boxes.clone()
    d[:, [0, 2]] *= wp / img
    d[:, [1, 3]] *= hp / img
    x1, y1, x2, y2 = torch.chunk(d[:, :, None], 4, 1)
    r = torch.arange(wp, dtype=d.dtype)[None, None, :]
    c = torch.arange(hp, dtype=d.dtype)[None, :, None]
    return (m * ((r >= x1) * (r < x2) * (c >= y1) * (c < y2))) > 0.5


def test_plain_mask_assembly_on_hand_made_cases():
    """A prototype of ones in channel 0: the mask is the crop where the
    coefficient is positive. Box edges on whole proto pixels are
    inclusive on the left, exclusive on the right; bit k of byte i is
    pixel 8 i + k; rows past num stay zero."""
    img, hp = 64, 16
    proto = torch.zeros((1, NM, hp, hp))
    proto[0, 0] = 1.0
    decode = torch.zeros((1, 4, 5 + NC + NM))
    decode[0, :, 5 + NC] = torch.tensor([1.0, 1.0, -1.0, 1.0])
    boxes = torch.tensor([[[8.0, 4.0, 20.0, 12.0],     # x 2..4, y 1..2
                           [8.5, 0.0, 36.1, 4.0],      # x 3..9, y 0
                           [0.0, 0.0, 64.0, 64.0],     # negative: empty
                           [0.0, 0.0, 64.0, 64.0]]])   # past num
    index = torch.tensor([[0, 1, 2, 3]], dtype=torch.int32)
    num = torch.tensor([3], dtype=torch.int32)
    out = M.assemble_masks(decode, index, boxes, num, proto, NC, (img, img))
    assert out.shape == (1, 4, hp, hp // 8) and out.dtype == torch.uint8
    want = torch.zeros_like(out)
    want[0, 0, 1:3, 0] = 0b00011100  # pixels 2, 3, 4
    want[0, 1, 0, 0] = 0b11111000    # pixels 3..7
    want[0, 1, 0, 1] = 0b00000011    # pixels 8, 9
    assert torch.equal(out, want)
    bits = np.unpackbits(out.numpy(), axis=-1, bitorder="little")
    v7 = _v7_masks(proto[0], decode[0, :3, 5 + NC:], boxes[0, :3], img)
    np.testing.assert_array_equal(bits[0, :3], v7.numpy())


@pytest.mark.parametrize("case", MASK_CASES[:2], ids=["b3_128", "b2_96"])
def test_plain_mask_assembly_is_v7s_process_mask(case):
    decode, index, boxes, num, proto, nc, hw = mask_assembly_case(
        case, dtype=torch.float32)
    out = M.assemble_masks(decode, index, boxes, num, proto, nc, hw)
    bits = np.unpackbits(out.numpy(), axis=-1, bitorder="little")
    assert not bits[0].any()  # image 0 keeps no box
    assert int(num[1]) == case[4]  # image 1 keeps max_det
    for i in range(case[0]):
        n = int(num[i])
        assert not bits[i, n:].any()
        if n:
            coef = decode[i, index[i, :n].long(), 5 + nc:]
            v7 = _v7_masks(proto[i], coef, boxes[i, :n], hw[0])
            np.testing.assert_array_equal(bits[i, :n], v7.numpy())


def test_run_batch_and_call(predictor, frames, weights):
    cfg, sd = weights
    boxes, scores, classes, num, bits, anchors = predictor.run_batch(frames)
    assert bits.shape == (2, 300, IMGSZ // 4, IMGSZ // 32)
    assert bits.dtype == np.uint8 and anchors.dtype == np.int32
    assert int(num.min()) > 0
    # the served masks against the reference's, at the served boxes and
    # anchors: f32 against f64 flips a bit only next to c . P = 0
    x = torch.from_numpy(frames).permute(0, 3, 1, 2).double() / 255
    with torch.no_grad():
        ref_dec, ref_proto = R.forward(
            cfg, {k: v.double() for k, v in sd.items()}, x)
    for i in range(2):
        served = {"boxes": boxes[i], "scores": scores[i],
                  "classes": classes[i]}
        assert mask_gap_one(ref_proto[i], ref_dec[i], NC, served,
                            anchors[i], bits[i], int(num[i]),
                            (IMGSZ, IMGSZ)) < 1e-3
    # __call__: a 3:4 frame letterboxed to 96 x 128, masks a box at its size
    frame = np.ascontiguousarray(frames[0, 16:112, :, ::-1])  # BGR, 96 x 128
    det = predictor(frame)
    n = len(det.xyxy[0])
    assert det.masks[0].shape == (n, 96, 128) and n > 0
    canvas = np.full((1, IMGSZ, IMGSZ, 3), 114, np.uint8)
    canvas[0, 16:112] = frame[:, :, ::-1]
    b2 = predictor.run_batch(canvas)
    m = np.unpackbits(b2[4][0, :n], axis=-1, bitorder="little")[:, 4:28]
    np.testing.assert_array_equal(det.masks[0],
                                  np.repeat(np.repeat(m, 4, 1), 4, 2))


def test_spans_and_counters(predictor, frames):
    profiling.reset()
    profiling.set_tracing(True)
    try:
        out = predictor.run_batch(frames)
        names = [s.name for s in profiling.spans()]
        c = profiling.counters()
    finally:
        profiling.set_tracing(False)
        profiling.reset()
    for name in ("forward.proto", "infer.nms", "infer.masks"):
        assert names.count(name) == 1, name
    assert "infer.seg_tail" not in names
    assert c["masks.images"] == 2 and c["masks.kept"] == int(out[3].sum())


def test_fp8_storage_reaches_proto(weights, frames):
    cfg, sd = weights
    plain, _ = build_model(cfg, seg_upsample=False)
    fp8, _ = build_model(cfg, seg_upsample=False, act_store="fp8")
    for m in (plain, fp8):
        load_state_dict(m, sd)
    x = torch.from_numpy(frames).permute(0, 3, 1, 2).float() / 255
    with torch.no_grad():
        (d0, _), p0 = plain(x)
        (d1, _), p1 = fp8(x)
    # Proto's output was stored in e4m3 and upcast, and differs
    assert torch.equal(p1.to(torch.float8_e4m3fn).float(), p1)
    assert not torch.equal(p0, p1)
    # the rows feeding the head stay fp; their inputs were stored
    assert not torch.equal(d0, d1) and d1.dtype == torch.float32


def test_fuse_reaches_proto(weights, frames):
    """``fuse()`` gives Proto's three ConvBnActs the one-pass epilogue and
    its upsample and 3x3 conv the phase fold (their plain versions on the
    CPU: BN's affine and the folded taps in f32, so within a few roundings
    of the separate ops)."""
    cfg, sd = weights
    model, _ = build_model(cfg, seg_upsample=False)
    load_state_dict(model, sd)
    x = torch.from_numpy(frames).permute(0, 3, 1, 2).float() / 255
    with torch.no_grad():
        (d0, _), p0 = model.eval()(x)
        proto = model.fuse().model[24].proto
        assert all("epilogue" in cv._derived
                   for cv in (proto.cv1, proto.cv2, proto.cv3))
        c_ = proto.cv2.conv.out_channels
        assert proto.cv2._derived["phases"].shape == (4 * c_, c_, 2, 2)
        (d1, _), p1 = model(x)
    torch.testing.assert_close(p1, p0, rtol=1e-4, atol=1e-6)
    torch.testing.assert_close(d1, d0, rtol=1e-4, atol=1e-4)


def test_the_programs_without_a_segment_path_refuse_it(weights):
    from desenet_tpu_torch.train import make_train_step
    from desenet_tpu_torch.train.engine import load_hyp, loss_and_schedule

    cfg, sd = weights
    model, spec = build_model(cfg, seg_upsample=False, train=True)
    det_loss, opt_cfg, lf = loss_and_schedule(load_hyp(), spec, IMGSZ, 10)
    with pytest.raises(NotImplementedError, match="Segment"):
        make_train_step(model, det_loss, opt_cfg, lf, nb=4, warmup_iters=4,
                        nominal_bs=2, batch_size=2, fused_seg=True)
    with pytest.raises(NotImplementedError, match="Segment"):
        Validator(build_model(cfg)[0].eval(), nc=NC, se_nc=0)
    with pytest.raises(ValueError, match="Segment"):
        Predictor(cfg, sd, imgsz=IMGSZ, half=False, device="cpu", int8=True,
                  calib=[np.zeros((IMGSZ, IMGSZ, 3), np.uint8)])
