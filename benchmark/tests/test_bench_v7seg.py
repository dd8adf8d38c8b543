"""The instance-segmentation cell ``x7seg.serve.b128`` on the CPU at a
tiny size (the look for a card skipped), its manifest entry, its FLOP
count and bound, its new readers, and ``mask_gap`` on hand-made faults.

- The manifest names the configuration and the cell, with nothing
  ``reduced``, and the four new metrics list only this cell.
- ``forward_flops`` gives v7.0's 265.6 GFLOP at 640.
- The cell (width 0.25, depth 0.33, 128 px, float32) runs correct,
  traced, and its readers find the mask kernel's counters.
- The fp8 control in the program's place (``control_instseg.py``'s)
  runs, and ``correct`` comes out false, on both numbers.
- ``mask_gap`` reads 0 on the reference's own masks and ``FAULT`` on each
  fault: the crop one proto pixel off and two boxes' masks swapped (set
  bits outside a box's crop), every anchor shifted by one (another
  detection's row), one box's coefficients negated (its mask inverted
  inside the crop: more than half its decided pixels flipped; a box with
  fewer than ``MIN_DECIDED`` decided pixels reads its ``reach``, as
  rounding could).
"""

import copy
import time

import numpy as np
import pytest
import torch

from benchmark import run as R
from benchmark.counts.v7seg import forward_flops, mask_assembly_bound
from benchmark.harness import cell as C
from benchmark.harness.frames import letterbox_input, make_frames
from benchmark.harness.weights_v7seg import seeded_weights
from benchmark.reference import v7seg as V
from benchmark.reference.instseg import (FAULT, MIN_DECIDED, box_readings,
                                         mask_gap_one)
from benchmark.reference.judge import reference_nms

CELL = "x7seg.serve.b128"
SEED = 2147483693
NEW = ("proto_ms.serve", "mask_ms.serve", "mask_roofline.serve",
       "masks_per_image.serve")


def tiny(conf: dict) -> dict:
    c = copy.deepcopy(conf)
    c.update(imgsz=128, dtype="float32")
    c["init"]["bn_calibration_frames"] = 2
    c["model"].update(width_multiple=0.25, depth_multiple=0.33)
    return c


@pytest.fixture
def tiny_cell(monkeypatch):
    torch.set_num_threads(2)
    workload, config = C.workload, C.config

    def wl(name):
        w = copy.deepcopy(workload(name))
        w["params"].update(batch=2, pool=2, frame_hw=[96, 128], sample=1,
                           sample_from=2, trace_at=1, trace_calls=2,
                           warmup=1)
        return w

    monkeypatch.setattr(C, "workload", wl)
    monkeypatch.setattr(C, "config", lambda name: tiny(config(name)))
    return C


def test_manifest_entries():
    man = C.manifest()
    conf = next(c for c in man["configs"] if c["name"] == "yolov5x_v7seg")
    assert conf["reduced"] == [] and "v7.0" in conf["source"]
    cell = next(w for w in man["workloads"] if w["name"] == CELL)
    assert (cell["config"], cell["traffic"], cell["chips"]) == (
        "yolov5x_v7seg", "offline.b128.vga", 1)
    assert CELL in next(m for m in man["end_to_end"]
                        if m["name"] == "serve_img_s")["workloads"]
    per = {m["name"]: m for m in man["per_layer"]}
    for name in NEW:
        assert per[name]["workloads"] == [CELL]
    for name in ("k2_roofline.serve", "seg_head_ms.serve", "p6_ms.serve"):
        assert CELL not in per[name]["workloads"]
    wl = C.workload(CELL)
    assert set(wl["limits"]) == {"det_gap", "mask_gap"}
    assert all(v > 0 for v in wl["limits"].values())


def test_flop_count_and_bound():
    conf = C.config("yolov5x_v7seg")
    assert forward_flops(conf["model"], 640, 640) == pytest.approx(
        265.6e9, rel=5e-3)
    # b128 at 640: 210 MB of bf16 prototypes and 123 MB of bits: bytes
    ms, by = mask_assembly_bound(128, 160, 160, 32, 300, 12800, 8e6)
    assert by == "bytes" and ms == pytest.approx(
        (128 * 32 * 160 * 160 * 2 + 4 * 32 * 12800 + 128 * 300 * 3200)
        / 3.35e12 * 1e3)


def test_tiny_traced_run_is_correct(tiny_cell):
    res = R.execute(CELL, SEED, 1.0, True, torch.device("cpu"),
                    time.perf_counter())
    assert res["correct"], res["checks"]
    m = res["metrics"]
    assert m["masks_per_image.serve"]["value"] > 10
    assert m["k1_candidates.serve"]["value"] > 10
    # no card: no device rows, no device spans
    for name in ("proto_ms.serve", "mask_ms.serve", "mask_roofline.serve"):
        assert name not in m


def test_tiny_control_fails(tiny_cell, monkeypatch):
    import desenet_tpu_torch.api as api

    build = api.build_model

    def fp8(cfg, **kw):
        return build(cfg, act_store="fp8", **kw)

    monkeypatch.setattr(api, "build_model", fp8)
    res = R.execute(CELL, SEED, 1.0, False, torch.device("cpu"),
                    time.perf_counter())
    assert not res["correct"]
    for c in res["checks"].values():
        assert c["value"] > c["limit"], res["checks"]


def test_mask_readers_on_synthetic_records():
    rows = [("void mask_assembly_kernel<true>(...)", 0.0, 150.0),
            ("void mask_assembly_kernel<true>(...)", 500.0, 650.0),
            ("other", 0.0, 1e6)]
    work = {"b": 128, "hp": 160, "wp": 160, "nm": 32, "max_det": 300,
            "kept": 12800.0, "crop_px": 8e6}
    rec = {"device": rows, "calls": 2, "mask_work": work}
    assert C.load_module("metrics", "mask_ms.serve").read(rec) == \
        pytest.approx(0.15)
    bound, _ = mask_assembly_bound(**work)
    assert C.load_module("metrics", "mask_roofline.serve").read(rec) == \
        pytest.approx(100 * bound / 0.15)
    for name in NEW:
        assert C.load_module("metrics", name).read({}) is None


@pytest.fixture(scope="module")
def judged():
    """The tiny model's reference decode and prototypes on two frames, and
    its kept boxes with their anchors, as a program would serve them."""
    torch.set_num_threads(2)
    conf = tiny(C.config("yolov5x_v7seg"))
    cfg = conf["model"]
    sd = seeded_weights(conf, 11, torch.device("cpu"))
    x = letterbox_input(make_frames(2, 96, 128, 12, "cpu"), 128)
    with torch.no_grad():
        dec, proto = V.forward(cfg, sd, x)
    nc = V.segment_row(cfg)["nc"]
    out = []
    for i in range(2):
        d = dec[i, :, :5 + nc].double()
        conf_ = d[:, 5:] * d[:, 4:5]
        best, _ = conf_.max(1)
        kept = reference_nms(dec[i:i + 1, :, :5 + nc], 0.25, 0.45, 300)[0]
        # each kept box's anchor: the candidate with its score and box
        anchors = torch.stack([torch.nonzero(best == s)[0, 0]
                               for s in kept["scores"]])
        served = {k: kept[k].float().numpy()
                  for k in ("boxes", "scores", "classes")}
        boxes = served["boxes"]
        n = len(boxes)
        ref = V.masks(proto[i], dec[i, anchors, 5 + nc:], kept["boxes"],
                      (128, 128))
        bits = np.zeros((300, 32, 4), np.uint8)
        bits[:n] = np.packbits(ref.numpy(), axis=-1, bitorder="little")
        out.append((proto[i], dec[i], nc, served, anchors.numpy(), bits, n))
    return out


def _gap(case, **swap):
    proto, dec, nc, served, anchors, bits, n = case
    args = dict(served=served, anchors=anchors, bits=bits)
    args.update(swap)
    return mask_gap_one(proto, dec, nc, args["served"], args["anchors"],
                        args["bits"], n, (128, 128))


def test_mask_gap_reads_zero_on_the_references_masks(judged):
    for case in judged:
        assert case[6] > 10
        assert _gap(case) == 0.0


def test_mask_gap_sees_each_fault(judged):
    proto, dec, nc, served, anchors, bits, n = judged[0]
    boxes = served["boxes"]
    # the crop one proto pixel (4 input pixels) to the right
    shifted = boxes.copy()
    shifted[:, [0, 2]] += 4.0
    ref = V.masks(proto, dec[torch.as_tensor(anchors).long(), 5 + nc:],
                  torch.as_tensor(shifted), (128, 128))
    off = bits.copy()
    off[:n] = np.packbits(ref.numpy(), axis=-1, bitorder="little")
    assert _gap(judged[0], bits=off) == FAULT
    # the masks of two boxes swapped
    sw = bits.copy()
    sw[[0, 1]] = sw[[1, 0]]
    assert _gap(judged[0], bits=sw) == FAULT
    # every anchor shifted by one, in each image: the masks and boxes as
    # served, the rows another detection's
    for proto_i, dec_i, _, served_i, anchors_i, bits_i, n_i in judged:
        moved = np.minimum(anchors_i + 1, dec_i.shape[0] - 1)
        assert mask_gap_one(proto_i, dec_i, nc, served_i, moved, bits_i,
                            n_i, (128, 128)) == FAULT
    # one box's coefficients negated: its mask inverted inside the crop,
    # each box in turn: FAULT, but where the box has too few decided
    # pixels to be judged whole, and there its reach
    r = box_readings(proto, dec, nc, served, anchors, bits, n, (128, 128))
    whole = 0
    for j in range(n):
        inside = V.crop(torch.as_tensor(boxes[j:j + 1]), 32, 32,
                        (128, 128))[0].numpy()
        neg = bits.copy()
        one = np.unpackbits(neg[j], axis=-1, bitorder="little").astype(bool)
        neg[j] = np.packbits(one ^ inside, axis=-1, bitorder="little")
        got = _gap(judged[0], bits=neg)
        if int(r["decided"][j]) >= MIN_DECIDED:
            assert got == FAULT, j
            whole += 1
        else:
            assert got == pytest.approx(float(r["reach"][j])), j
    assert whole >= 0.9 * n, (whole, n)
    # a bit set past num, an anchor outside the decode
    past = bits.copy()
    past[n, 0, 0] = 1
    assert _gap(judged[0], bits=past) == FAULT
    bad = anchors.copy()
    bad[0] = dec.shape[0]
    assert _gap(judged[0], anchors=bad) == FAULT
