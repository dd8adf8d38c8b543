"""The inference surface as a whole, JAX vs port, on the CPU.

One module-scoped pair of checkpoints (``torch_detect_case``: tiny_psp2's
weights in a JAX (orbax) checkpoint, crossed into a port checkpoint through
``train_state_from_jax``; a second member with perturbed weights for the
ensemble) and three PNG images of other sizes. ``desenet_tpu.cli.detect.run``
and ``desenet_tpu_torch.cli.detect.run`` (f32, ``--save-txt --save-conf``)
write the same label files: the same files, classes exact, xywh and conf
within 1e-4 (rows matched as sets: picks whose scores differ by float
rounding may come in another order). Plain, ``--classes``,
``--agnostic-nms``, ``--augment``, two ``--weights`` and ``--save-crop``
(the same crop files, of the same shapes). Every image keeps fewer than
2048 candidates (252 anchors at 64 px, 756 with TTA), so the JAX CPU
path's ``pre_topk=2048`` never binds where the port has no cap.

``load_predictor`` against the JAX ``Predictor`` on the same checkpoint,
``Detections``' outputs against JAX's on the same inputs, and
``cli.detect`` refusing ``--device cuda`` without a card.
"""

import os

import cv2
import numpy as np
import pytest
import torch

import torch_detect_case as D
from desenet_tpu.api import Detections as JaxDetections
from desenet_tpu.api import Predictor as JaxPredictor
from desenet_tpu.cli import detect as jax_detect
from desenet_tpu_torch.api import Detections, load_predictor
from desenet_tpu_torch.cli import detect

CONF = 0.005  # 9 to 35 detections over the three images
TOL = 1e-4


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    yield from D.one_thread()


@pytest.fixture(scope="module")
def case(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("detect"))
    ckpts = [D.write_checkpoints(root, k) for k in (0, 1)]
    src = os.path.join(root, "src")
    os.makedirs(src)
    rng = np.random.default_rng(3)
    for i, hw in enumerate([(64, 64), (48, 80), (96, 72)]):
        cv2.imwrite(os.path.join(src, f"im{i}.png"),
                    rng.integers(0, 256, (*hw, 3), dtype=np.uint8))
    return root, ckpts, src


def labels(out: str) -> dict:
    d = os.path.join(out, "labels")
    return {f: np.loadtxt(os.path.join(d, f), ndmin=2)
            for f in sorted(os.listdir(d))}


def assert_same_labels(got: dict, want: dict):
    assert sorted(got) == sorted(want)
    assert sum(len(v) for v in want.values()) > 0
    for f in want:
        g, w = got[f], want[f]
        assert g.shape == w.shape, (f, g.shape, w.shape)
        free = list(range(len(w)))
        for row in g:
            hit = [j for j in free if row[0] == w[j, 0]
                   and np.abs(row[1:] - w[j, 1:]).max() <= TOL]
            assert hit, (f, row, w)
            free.remove(hit[0])


CASES = {
    "plain": dict(save_crop=True),
    "classes": dict(classes=[0, 2]),
    "agnostic": dict(agnostic_nms=True),
    "augment": dict(augment=True),
    "ensemble": dict(),
}


@pytest.mark.parametrize("name", list(CASES))
def test_detect_labels_match_jax(case, name, tmp_path):
    _, ckpts, src = case
    members = 2 if name == "ensemble" else 1
    kw = dict(imgsz=64, conf_thres=CONF, half=False, save_txt=True,
              save_conf=True, exist_ok=True, **CASES[name])
    want = jax_detect.run([c[0] for c in ckpts[:members]], src,
                          project=str(tmp_path), name="jax", **kw)
    got = detect.run([c[1] for c in ckpts[:members]], src,
                     project=str(tmp_path), name="port", device="cpu", **kw)
    assert_same_labels(labels(got), labels(want))
    assert sorted(os.listdir(got)) == sorted(os.listdir(want))
    if name == "plain":
        crops = {}
        for out in (got, want):
            base = os.path.join(out, "crops")
            crops[out] = {os.path.relpath(os.path.join(r, f), base):
                          cv2.imread(os.path.join(r, f)).shape
                          for r, _, fs in os.walk(base) for f in fs}
        assert crops[got] == crops[want] and crops[got]


def test_detect_main_flags_and_device(case, tmp_path):
    """The CLI's argv path (``--classes``, ``--max-det``, ``--hide-conf``,
    ``--nosave``) against ``run``, and ``--device cuda`` without a card
    refused before anything is written."""
    _, ckpts, src = case
    argv = ["--weights", ckpts[0][1], "--source", src, "--img-size", "64",
            "--conf-thres", str(CONF), "--no-half", "--save-txt",
            "--save-conf", "--classes", "0", "1", "--max-det", "2",
            "--hide-conf", "--nosave", "--project", str(tmp_path)]
    out = detect.main(argv + ["--device", "cpu", "--name", "a"])
    ref = detect.run(ckpts[0][1], src, 64, CONF, max_det=2, save_txt=True,
                     save_conf=True, classes=[0, 1], nosave=True, half=False,
                     project=str(tmp_path), name="b", device="cpu")
    assert labels(out).keys() == labels(ref).keys()
    for f, v in labels(out).items():
        np.testing.assert_array_equal(v, labels(ref)[f])
        assert len(v) <= 2 and set(v[:, 0]) <= {0, 1}
    assert sorted(os.listdir(out)) == ["labels"]  # --nosave
    if torch.cuda.is_available():
        return
    with pytest.raises(RuntimeError, match="no CUDA card"):
        detect.main(argv + ["--name", "c"])
    assert not os.path.exists(os.path.join(str(tmp_path), "c"))


def test_load_predictor_matches_jax_predictor(case):
    _, ckpts, src = case
    imgs = [cv2.imread(os.path.join(src, f)) for f in sorted(os.listdir(src))]
    want = JaxPredictor(ckpts[0][0], imgsz=64, conf_thres=CONF,
                        half=False)(imgs)
    pred = load_predictor(ckpts[0][1], imgsz=64, conf_thres=CONF,
                          half=False, device="cpu")
    assert pred.names == D.DE_NAMES and pred.se_names == D.SE_NAMES
    # a JAX (orbax) checkpoint is not read: it crosses through the JAX
    # package and train_state_from_jax
    with pytest.raises(FileNotFoundError, match="train_state_from_jax"):
        load_predictor(ckpts[0][0], device="cpu")
    got = pred(imgs)
    assert sum(len(d) for d in want.xyxy) > 0
    for g, w in zip(got.xyxyn, want.xyxyn):
        assert g.shape == w.shape
        np.testing.assert_array_equal(g[:, 5], w[:, 5])
        # boxes normalized by the native size, as the label files are
        dist = np.abs(g[:, None, :5] - w[None, :, :5]).max(-1)
        assert dist.min(1).max() <= TOL and dist.min(0).max() <= TOL
    for g, w in zip(got.masks, want.masks):
        assert g.shape == w.shape and (g == w).mean() >= 0.999


def test_detections_outputs_match_jax(tmp_path):
    rng = np.random.default_rng(4)
    imgs = [rng.integers(0, 256, (h, w, 3), dtype=np.uint8)
            for h, w in [(60, 90), (120, 80)]]
    xyxy = []
    for im in imgs:
        h, w = im.shape[:2]
        n = 4
        x1 = rng.uniform(0, w * 0.6, n)
        y1 = rng.uniform(0, h * 0.6, n)
        xyxy.append(np.stack([x1, y1, x1 + rng.uniform(5, w * 0.4, n),
                              y1 + rng.uniform(5, h * 0.4, n),
                              rng.uniform(0.3, 1, n),
                              rng.integers(0, 3, n).astype(np.float64)], 1))
    masks = [rng.integers(0, 2, im.shape[:2]).astype(np.uint8) for im in imgs]
    # render draws on the images it was given, in both packages: each
    # container gets its own copies
    got, want = (cls([im.copy() for im in imgs], xyxy, masks, D.DE_NAMES,
                     D.SE_NAMES) for cls in (Detections, JaxDetections))
    for kind in ("xyxy", "xywh", "xyxyn", "xywhn"):
        for g, w in zip(getattr(got, kind), getattr(want, kind)):
            np.testing.assert_array_equal(g, w)
        for g, w in zip(got.pandas(kind), want.pandas(kind)):
            assert g.equals(w)
    assert got.to_dicts() == want.to_dicts() and repr(got) == repr(want)
    parts = got.tolist()
    assert len(parts) == 2 and [p.to_dicts()[0] for p in parts] == \
        [p.to_dicts()[0] for p in want.tolist()]
    for g, w in zip(got.render(), want.render()):
        np.testing.assert_array_equal(g, w)
    for what in ("save", "crop"):
        gdir = getattr(got, what)(str(tmp_path / f"port_{what}"))
        wdir = getattr(want, what)(str(tmp_path / f"jax_{what}"))
        names = sorted(os.listdir(wdir))
        assert sorted(os.listdir(gdir)) == names and names
        for f in names:
            np.testing.assert_array_equal(cv2.imread(os.path.join(gdir, f)),
                                          cv2.imread(os.path.join(wdir, f)))
