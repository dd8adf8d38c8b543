"""The plain reference against the port on the CPU at small sizes: the
same weights (the benchmark's recipe) give the same decode and seg logits
in float64 (in float32 the two sum in other orders, and a random network
with calibrated BN spreads that to 1e-3 to 1e-2), and the judge finds no
gap in what the port serves in float32."""

import numpy as np
import pytest
import torch

from benchmark.harness import cell as C
from benchmark.harness.frames import letterbox_rgb, make_frames
from benchmark.harness.weights import seeded_weights
from benchmark.reference.desenet import forward, param_specs
from benchmark.reference.judge import judge


def _close(got, want, rtol):
    err = ((got - want).abs() / (want.abs() + 1.0)).max().item()
    assert err <= rtol, err


@pytest.mark.parametrize("name,size", [("yolov5s_seg", 128),
                                       ("yolov5l_seg", 64)])
def test_reference_matches_the_port(name, size):
    from desenet_tpu_torch.api import Predictor

    torch.set_num_threads(4)
    conf = dict(C.config(name), imgsz=size)
    conf["init"] = dict(conf["init"], bn_calibration_frames=2)
    sd = seeded_weights(conf, 2147483659, torch.device("cpu"))
    assert [k for k, *_ in param_specs(conf["model"])] == list(sd)
    pred = Predictor(conf["model"], sd, imgsz=size, half=False,
                     device="cpu")
    batch = letterbox_rgb(make_frames(2, size * 3 // 4, size, 3,
                                      "cpu").numpy(), size)
    x = torch.from_numpy(batch).permute(0, 3, 1, 2).float() / 255
    with torch.no_grad():
        (dec, _), seg = pred.model.double()(x.double())
        pred.model.float()
        rdec, rseg = forward(conf["model"],
                             {k: v.double() for k, v in sd.items()},
                             x.double())
        _close(dec, rdec, 1e-6)  # the port decodes in float32
        _close(seg, rseg, 1e-9)
        rdec, rseg = forward(conf["model"], sd, x)
    boxes, scores, classes, num, seg_cls = pred.run_batch(batch)
    served = [{"boxes": boxes[i, :num[i]], "scores": scores[i, :num[i]],
               "classes": classes[i, :num[i]], "seg": seg_cls[i]}
              for i in range(len(batch))]
    nums = judge(served, rdec, rseg, pred.conf_thres, pred.iou_thres,
                 pred.max_det)
    assert sum(nums["candidates"]) > 0
    for k in ("det_gap",):
        assert nums[k] < 5e-3, (k, nums[k])
    assert nums["seg_gap"] < 1e-2 * float(rseg.abs().max())


def test_judge_sees_a_moved_box_and_a_missing_image():
    g = torch.Generator().manual_seed(0)
    dec = torch.rand((2, 50, 7), generator=g, dtype=torch.float64)
    dec[..., :2] *= 100
    dec[..., 2:4] = dec[..., 2:4] * 30 + 10
    dec[..., 4:] = dec[..., 4:] * 0.5 + 0.5
    logits = torch.rand((2, 3, 4, 4), generator=g)
    from benchmark.reference.judge import reference_nms, seg_upsample

    kept = reference_nms(dec, 0.25, 0.45, 300)
    seg = [seg_upsample(logits[i:i + 1])[0].argmax(0).numpy()
           for i in range(2)]
    served = [{"boxes": k["boxes"].numpy(), "scores": k["scores"].numpy(),
               "classes": k["classes"].numpy(), "seg": s}
              for k, s in zip(kept, seg)]
    good = judge(served, dec, logits, 0.25, 0.45, 300)
    assert max(good[k] for k in ("det_gap",
                                 "seg_gap")) < 1e-6
    moved = [dict(s) for s in served]
    moved[0]["boxes"] = moved[0]["boxes"] + 8.0
    assert judge(moved, dec, logits, 0.25, 0.45, 300)["det_gap"] > 0.1
    gone = [dict(s) for s in served]
    gone[1] = {"boxes": np.zeros((0, 4)), "scores": np.zeros(0),
               "classes": np.zeros(0), "seg": np.zeros_like(seg[1])}
    out = judge(gone, dec, logits, 0.25, 0.45, 300)
    assert out["det_gap"] > 0.2
