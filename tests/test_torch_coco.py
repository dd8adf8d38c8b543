"""The port's COCO scorer (``desenet_tpu_torch/eval/coco.py``) against the
JAX package's (``desenet_tpu/eval/coco.py``): the same 12 summary stats,
exactly (both are numpy), on the cases of tests/test_coco_eval.py (with
their analytic values) and on a random 20-image set with crowds, every
area range and a category without ground truth, read from json files."""

import json

import numpy as np
import pytest

from desenet_tpu.eval import coco as jax_coco
from desenet_tpu_torch.eval import coco


def gt(anns, imgs=(1,), cats=(1,)):
    return {"images": [{"id": i} for i in imgs],
            "categories": [{"id": c} for c in cats],
            "annotations": [dict(id=k + 1, **a) for k, a in enumerate(anns)]}


def ann(img, cat, bbox, **kw):
    return dict(image_id=img, category_id=cat, bbox=list(map(float, bbox)),
                **kw)


def det(img, cat, bbox, score):
    return {"image_id": img, "category_id": cat,
            "bbox": list(map(float, bbox)), "score": float(score)}


# (name, ground truth, predictions, img_ids, {stat index: analytic value})
CASES = [
    ("perfect", gt([ann(1, 1, [10, 10, 50, 50])]),
     [det(1, 1, [10, 10, 50, 50], 0.9)], None, {0: 1.0, 1: 1.0, 8: 1.0}),
    ("miss", gt([ann(1, 1, [10, 10, 50, 50])]),
     [det(1, 1, [200, 200, 10, 10], 0.9)], None, {0: 0.0, 1: 0.0}),
    ("iou 0.6", gt([ann(1, 1, [0, 0, 100, 60])]),
     [det(1, 1, [0, 0, 100, 100], 0.9)], None, {0: 0.3, 1: 1.0, 2: 0.0}),
    ("trailing fp", gt([ann(1, 1, [0, 0, 10, 10])]),
     [det(1, 1, [0, 0, 10, 10], 0.9), det(1, 1, [100, 100, 10, 10], 0.1)],
     None, {1: 1.0}),
    ("fp before tp", gt([ann(1, 1, [0, 0, 10, 10])]),
     [det(1, 1, [100, 100, 10, 10], 0.9), det(1, 1, [0, 0, 10, 10], 0.1)],
     None, {1: 0.5}),
    ("crowd", gt([ann(1, 1, [0, 0, 10, 10]),
                  ann(1, 1, [50, 50, 100, 100], iscrowd=1)]),
     [det(1, 1, [0, 0, 10, 10], 0.9), det(1, 1, [60, 60, 20, 20], 0.8)],
     None, {1: 1.0}),
    ("category mean", gt([ann(1, 1, [0, 0, 10, 10]),
                          ann(1, 2, [50, 50, 10, 10])], cats=(1, 2)),
     [det(1, 1, [0, 0, 10, 10], 0.9)], None, {1: 0.5}),
    ("area ranges", gt([ann(1, 1, [0, 0, 16, 16]),
                        ann(1, 1, [300, 300, 200, 200])]),
     [det(1, 1, [0, 0, 16, 16], 0.9), det(1, 1, [300, 300, 200, 200], 0.8)],
     None, {3: 1.0, 4: -1.0, 5: 1.0}),
    ("max dets", gt([ann(1, 1, [0, 0, 10, 10]), ann(1, 1, [50, 50, 10, 10])]),
     [det(1, 1, [0, 0, 10, 10], 0.9), det(1, 1, [50, 50, 10, 10], 0.8)],
     None, {6: 0.5, 8: 1.0}),
    ("score order", gt([ann(1, 1, [0, 0, 10, 10])]),
     [det(1, 1, [1, 1, 10, 10], 0.3), det(1, 1, [0, 0, 10, 10], 0.9)],
     None, {2: 1.0}),
    ("all images", gt([ann(1, 1, [0, 0, 10, 10]), ann(2, 1, [0, 0, 10, 10])],
                      imgs=(1, 2)),
     [det(1, 1, [0, 0, 10, 10], 0.9)], None, {8: 0.5}),
    ("img_ids filter", gt([ann(1, 1, [0, 0, 10, 10]),
                           ann(2, 1, [0, 0, 10, 10])], imgs=(1, 2)),
     [det(1, 1, [0, 0, 10, 10], 0.9)], [1], {1: 1.0}),
    ("gt-less category", gt([ann(1, 1, [0, 0, 10, 10], area=100, iscrowd=0)],
                            cats=(1, 2)),
     [det(1, 1, [0, 0, 10, 10], 0.9), det(1, 2, [20, 20, 5, 5], 0.8)],
     None, {1: 1.0}),
]


@pytest.mark.parametrize("case", CASES, ids=[c[0] for c in CASES])
def test_evaluate_coco_matches_jax(case):
    _, anno, preds, img_ids, expect = case
    got = coco.evaluate_coco(anno, preds, img_ids=img_ids, quiet=True)
    want = jax_coco.evaluate_coco(anno, preds, img_ids=img_ids, quiet=True)
    np.testing.assert_array_equal(got, want)
    for i, v in expect.items():
        assert got[i] == pytest.approx(v)


def random_set(rng, n_img=20, cats=(1, 2, 3)):
    """Ground truth of ``n_img`` images (string and int ids) with 0 to 6
    boxes each over every area range, one in ten a crowd, and category 3
    without ground truth; predictions: jittered copies of most boxes with
    random scores, plus false positives in every category."""
    imgs = [i if i % 2 else f"img_{i}" for i in range(n_img)]
    anns, preds = [], []
    for im in imgs:
        for _ in range(rng.integers(0, 7)):
            side = float(rng.choice([12, 50, 150])) * rng.uniform(0.8, 1.2)
            box = [*rng.uniform(0, 400, 2), side, side * rng.uniform(0.5, 2)]
            cat = int(rng.integers(1, 3))
            anns.append(ann(im, cat, box, iscrowd=int(rng.uniform() < 0.1)))
            if rng.uniform() < 0.8:
                jit = rng.uniform(-0.15, 0.15, 4) * box[2]
                preds.append(det(im, cat, np.asarray(box) + jit,
                                 rng.uniform(0.05, 1)))
        for _ in range(rng.integers(0, 4)):
            preds.append(det(im, int(rng.choice(cats)),
                             [*rng.uniform(0, 400, 2), *rng.uniform(8, 120, 2)],
                             rng.uniform(0, 0.6)))
    return gt(anns, imgs=imgs, cats=cats), preds


@pytest.mark.parametrize("seed", [0, 1])
def test_random_set_from_json_files_matches_jax(seed, tmp_path):
    anno, preds = random_set(np.random.default_rng(seed))
    anno_path, pred_path = str(tmp_path / "gt.json"), str(tmp_path / "p.json")
    with open(anno_path, "w") as fh:
        json.dump(anno, fh)
    with open(pred_path, "w") as fh:
        json.dump(preds, fh)
    got = coco.evaluate_coco(anno_path, pred_path, quiet=True)
    want = jax_coco.evaluate_coco(anno_path, pred_path, quiet=True)
    np.testing.assert_array_equal(got, want)
    assert 0 < got[0] < got[1] <= 1
    # the IoU helper alone, crowds included
    d = np.asarray([p["bbox"] for p in preds[:8]])
    g = np.asarray([a["bbox"] for a in anno["annotations"][:5]])
    crowd = [bool(a["iscrowd"]) for a in anno["annotations"][:5]]
    np.testing.assert_array_equal(coco.box_iou_xywh(d, g, crowd),
                                  jax_coco.box_iou_xywh(d, g, crowd))
