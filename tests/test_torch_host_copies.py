"""The port's own copies of the JAX package's numpy-only host modules
(``desenet_tpu_torch`` imports nothing of ``desenet_tpu``) against the
originals, on the CPU, on the same inputs made with numpy from a seed:

- ``utils/metrics.py``: the AP family, the confusion matrix and the seg
  metrics at 1e-12 (the same float64 numpy arithmetic);
- ``utils/general.py``: ``check_img_size``, ``increment_path``,
  ``coco80_to_coco91_class``, ``check_dataset`` equal;
- ``data/``: the validation dataloader (``augment=False, rect=True``) on a
  ``tools/make_fake_dataset.py`` split with mixed aspect ratios, batch by
  batch, arrays equal (needs cv2 and PIL; the JAX package's optional C++
  rasterizer is bit-identical to the PIL fill the port uses);
- ``serve.py``: ``BatchRunner``'s buckets, padding, ordering and shedding on
  a stub predictor;
- ``native.py`` and ``csrc/host/fastops.cpp``: the C++ source is the JAX
  package's ``native/fastops.cpp``, its space-to-depth assembler included,
  line for line outside comments, and the wrapper's copy of the JAX wrapper's
  frame-header parse reads each JPEG's size (``tests/test_torch_native.py``
  holds the built libraries and the wrappers against each other);
- ``data/converters.py``: the same label files, byte for byte, from seeded
  VOC xml and labelme json;
- ``data/misc_tools.py``: the same folders, flattened copies, autosplit
  index files (one seed), box crops and renames on copies of one seeded
  dataset;
- ``utils/wandb_offline.py``: the same run directory from the same calls
  (up to the media files' time-stamped names), and each package reading
  the other's artifacts by alias.
"""

import os
import sys

import numpy as np
import pytest

from desenet_tpu import serve as jax_serve
from desenet_tpu.utils import general as jax_general
from desenet_tpu.utils import metrics as jax_metrics
from desenet_tpu_torch import serve as port_serve
from desenet_tpu_torch.utils import general as port_general
from desenet_tpu_torch.utils import metrics as port_metrics

HERE = os.path.dirname(os.path.abspath(__file__))
TOL = dict(rtol=1e-12, atol=1e-12)


def detections(rng, n, nc):
    xy = rng.uniform(0, 500, (n, 2))
    wh = rng.uniform(10, 150, (n, 2))
    return np.concatenate([xy, xy + wh, rng.uniform(0.01, 1, (n, 1)),
                           rng.integers(0, nc, (n, 1))], 1)


def labels(rng, m, nc):
    xy = rng.uniform(0, 500, (m, 2))
    wh = rng.uniform(10, 150, (m, 2))
    return np.concatenate([rng.integers(0, nc, (m, 1)), xy, xy + wh], 1)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_ap_per_class_and_matching_equal(seed):
    rng = np.random.default_rng(seed)
    nc, iouv = 4, np.linspace(0.5, 0.95, 10)
    dets, lbls = detections(rng, 60, nc), labels(rng, 12, nc)
    # some detections on top of labels, so that there are true positives
    dets[:12, :4] = lbls[:, 1:] + rng.normal(0, 3, (12, 4))
    dets[:12, 5] = lbls[:, 0]
    got = port_metrics.match_predictions(dets, lbls, iouv)
    want = jax_metrics.match_predictions(dets, lbls, iouv)
    assert got.any() and np.array_equal(got, want)
    np.testing.assert_allclose(port_metrics.np_box_iou(dets[:, :4], lbls[:, 1:]),
                               jax_metrics.np_box_iou(dets[:, :4], lbls[:, 1:]),
                               **TOL)
    args = (got, dets[:, 4], dets[:, 5], lbls[:, 0])
    for g, w in zip(port_metrics.ap_per_class(*args),
                    jax_metrics.ap_per_class(*args)):
        np.testing.assert_allclose(g, w, **TOL)
    rec = np.sort(rng.uniform(0, 1, 30))
    prec = np.sort(rng.uniform(0, 1, 30))[::-1]
    for g, w in zip(port_metrics.compute_ap(rec, prec),
                    jax_metrics.compute_ap(rec, prec)):
        np.testing.assert_allclose(g, w, **TOL)
    x = rng.uniform(0, 1, (3, 4))
    np.testing.assert_allclose(port_metrics.fitness(x), jax_metrics.fitness(x),
                               **TOL)
    np.testing.assert_allclose(port_metrics.fitness_det_seg(x[:1], 0.4),
                               jax_metrics.fitness_det_seg(x[:1], 0.4), **TOL)


@pytest.mark.parametrize("seed", [0, 1])
def test_confusion_matrix_equal(seed):
    rng = np.random.default_rng(seed)
    nc = 5
    got = port_metrics.ConfusionMatrix(nc)
    want = jax_metrics.ConfusionMatrix(nc)
    for _ in range(4):
        dets, lbls = detections(rng, 40, nc), labels(rng, 9, nc)
        dets[:9, :4] = lbls[:, 1:] + rng.normal(0, 2, (9, 4))
        got.process_batch(dets, lbls)
        want.process_batch(dets, lbls)
    assert got.matrix.sum() > 0
    np.testing.assert_allclose(got.matrix, want.matrix, **TOL)


@pytest.mark.parametrize("seed", [0, 1])
def test_seg_metrics_equal(seed):
    rng = np.random.default_rng(seed)
    nclass = 4
    got, want = port_metrics.SegMetrics(nclass), jax_metrics.SegMetrics(nclass)
    for _ in range(3):
        target = rng.integers(0, nclass, (2, 32, 48))
        pred = np.where(rng.uniform(size=target.shape) < 0.7, target,
                        rng.integers(0, nclass, target.shape))
        for g, w in zip(port_metrics.batch_pix_accuracy(pred, target),
                        jax_metrics.batch_pix_accuracy(pred, target)):
            assert g == w
        for g, w in zip(
                port_metrics.batch_intersection_union(pred, target, nclass),
                jax_metrics.batch_intersection_union(pred, target, nclass)):
            np.testing.assert_array_equal(g, w)
        got.update(pred, target)
        want.update(pred, target)
    assert 0 < got.miou < 1
    np.testing.assert_allclose(got.pix_acc, want.pix_acc, **TOL)
    np.testing.assert_allclose(got.ious, want.ious, **TOL)
    np.testing.assert_allclose(got.miou, want.miou, **TOL)


def test_general_functions_equal(tmp_path):
    for imgsz in (64, 100, 639, 640, 641):
        for s in (32, 64):
            assert port_general.check_img_size(imgsz, s) == \
                jax_general.check_img_size(imgsz, s)
    assert port_general.check_img_size(10, 32, floor=64) == 64
    assert port_general.coco80_to_coco91_class() == \
        jax_general.coco80_to_coco91_class()
    assert len(port_general.coco80_to_coco91_class()) == 80
    # increment_path: the same sequence of run dirs from either package
    # (names that no part of the temporary path repeats: the function looks
    # for "<stem><digits>" anywhere in a path)
    for mod, root in ((port_general, tmp_path / "a"),
                      (jax_general, tmp_path / "b")):
        seq = [mod.increment_path(root / "runzq", mkdir=True)
               for _ in range(3)]
        assert [p.name for p in seq] == ["runzq", "runzq2", "runzq3"]
        assert mod.increment_path(root / "runzq",
                                  exist_ok=True).name == "runzq"
        (root / "filezq.txt").write_text("x")
        assert mod.increment_path(root / "filezq.txt").name == "filezq2.txt"


def test_check_dataset_equal(tmp_path):
    pytest.importorskip("yaml", reason="check_dataset reads a yaml file")
    split = tmp_path / "Images" / "val"
    split.mkdir(parents=True)
    text = (f"train: {split}\nval: {split}\n"
            "de:\n  nc: 2\n  names: [a, b]\nse:\n  nc: 1\n  names: [bg]\n")
    good = tmp_path / "data.yaml"
    good.write_text(text)
    assert port_general.check_dataset(str(good)) == \
        jax_general.check_dataset(str(good))
    bad = tmp_path / "bad.yaml"
    bad.write_text(text.replace("nc: 2", "nc: 3"))
    with pytest.raises(ValueError, match="names"):
        port_general.check_dataset(str(bad))
    with pytest.raises(ValueError, match="missing 'val'"):
        port_general.check_dataset({"train": str(split)})


@pytest.fixture(scope="module")
def fake_split(tmp_path_factory):
    cv2 = pytest.importorskip("cv2", reason="the fake dataset and the "
                              "loaders' resize need cv2")
    pytest.importorskip("PIL", reason="the loaders decode images with PIL")
    sys.path.insert(0, os.path.join(os.path.dirname(HERE), "tools"))
    from make_fake_dataset import generate

    root = tmp_path_factory.mktemp("fakeds_copies")
    generate(str(root), n_train=1, n_val=9, size=96, de_nc=3, se_nc=2,
             seed=5)
    val = os.path.join(str(root), "Images", "val")
    # mixed aspect ratios (the labels are normalized, so they stay valid):
    # rect batches then differ in shape and the letterbox pads and shrinks
    for i, name in enumerate(sorted(os.listdir(val))):
        if i % 3:
            path = os.path.join(val, name)
            size = (144, 80) if i % 3 == 1 else (72, 120)
            cv2.imwrite(path, cv2.resize(cv2.imread(path), size))
    return val


@pytest.mark.parametrize("rect,single_cls", [(True, False), (False, False),
                                             (True, True)])
def test_val_dataloader_equal(fake_split, rect, single_cls):
    from desenet_tpu.data import create_mixed_dataloader as jax_loader
    from desenet_tpu_torch.data import create_mixed_dataloader as port_loader

    kw = dict(img_size=64, batch_size=4, augment=False, rect=rect, pad=0.5,
              stride=32, single_cls=single_cls, workers=2)
    (got_loader, got_ds), (want_loader, want_ds) = \
        port_loader(fake_split, **kw), jax_loader(fake_split, **kw)
    assert len(got_ds) == len(want_ds) == 9
    assert len(got_loader) == len(want_loader) == 3
    got, want = list(got_loader), list(want_loader)
    shapes = set()
    for g, w in zip(got, want):
        assert set(g) == set(w)
        for key in ("image", "det_targets", "det_mask", "seg_labels"):
            assert g[key].dtype == w[key].dtype
            np.testing.assert_array_equal(g[key], w[key])
        assert g["paths"] == w["paths"]
        assert repr(g["shapes"]) == repr(w["shapes"])
        shapes.add(g["image"].shape[1:3])
        assert g["det_mask"].any()
        # single_cls maps every seg class to 0 too
        assert g["seg_labels"].max() == (0 if single_cls else 1)
    if rect:
        assert len(shapes) > 1, shapes


def test_pad_det_targets_equal_and_augment_refused(fake_split):
    from desenet_tpu.data import pad_det_targets as jax_pad
    from desenet_tpu_torch.data import (create_mixed_dataloader,
                                        pad_det_targets)

    rng = np.random.default_rng(0)
    dets = [rng.uniform(0, 1, (n, 5)).astype(np.float32) for n in (0, 3, 9)]
    for g, w in zip(pad_det_targets(dets, 6), jax_pad(dets, 6)):
        np.testing.assert_array_equal(g, w)
    # the augmented path is ported (tests/test_torch_augment.py holds it
    # against the JAX package's), its image caches too
    # (tests/test_torch_native.py); a cache mode of neither kind is refused
    with pytest.raises(ValueError, match="cache_images"):
        create_mixed_dataloader(fake_split, img_size=64, batch_size=2,
                                augment=True, cache_images="vram")


class StubDetections:
    def __init__(self, imgs):
        self.imgs = imgs

    def to_dicts(self):
        # one "detection" per image carrying the image's tag (pixel 0)
        return [[{"tag": int(im[0, 0, 0])}] for im in self.imgs]


class StubPredictor:
    imgsz = 8
    names = ("a",)
    se_names = ("bg",)

    def __init__(self):
        self.batches = []

    def __call__(self, imgs):
        self.batches.append([int(im[0, 0, 0]) for im in imgs])
        return StubDetections(imgs)


def drive(mod, n_requests, max_batch):
    """Queue ``n_requests`` tagged images and drain them on this thread."""
    pred = StubPredictor()
    runner = mod.BatchRunner(pred, max_batch=max_batch, max_wait_ms=1.0,
                             max_queue=12)
    reqs = [mod._Pending(np.full((8, 8, 3), i, np.uint8), want_mask=False)
            for i in range(n_requests)]
    admitted = [runner.submit(r) for r in reqs]
    while runner._drain_once():
        pass
    results = [r.result for r, ok in zip(reqs, admitted) if ok]
    return pred.batches, admitted, results, dict(runner.stats)


@pytest.mark.parametrize("n,max_batch", [(1, 8), (3, 8), (5, 4), (8, 8),
                                         (11, 16), (15, 8)])
def test_batch_runner_buckets_and_order_equal(n, max_batch):
    got, want = drive(port_serve, n, max_batch), drive(jax_serve, n, max_batch)
    assert got == want
    batches, admitted, results, stats = got
    assert admitted == [i < 12 for i in range(n)]  # the queue holds 12
    served = sum(admitted)
    # each answer carries its own image's tag, in submission order
    assert [r["detections"][0]["tag"] for r in results] == list(range(served))
    # every batch is a power-of-two bucket, padded with the gray image
    for b in batches:
        assert len(b) == port_serve._bucket(len([t for t in b if t != 114]),
                                            max_batch)
    assert stats["requests"] == served and stats["shed"] == n - served
    assert stats["padded"] == sum(len(b) for b in batches) - served
    for k in range(1, 40):
        assert port_serve._bucket(k, 16) == jax_serve._bucket(k, 16)


def test_batch_runner_stops_and_joins():
    runner = port_serve.BatchRunner(StubPredictor(), max_batch=2)
    runner.start()
    req = port_serve._Pending(np.zeros((8, 8, 3), np.uint8), want_mask=False)
    assert runner.submit(req) and req.done.wait(10)
    runner.stop()
    runner.join(5)
    assert not runner.is_alive()
    assert not runner.submit(req)
    with pytest.raises(ValueError, match="max_batch"):
        port_serve.BatchRunner(StubPredictor(), max_batch=0)


def _code_lines(path, drop_fn=None):
    """The source's lines outside // comments, blank lines dropped, and
    without the function whose signature starts with ``drop_fn``."""
    out, skip, depth = [], False, 0
    with open(path) as fh:
        for line in fh:
            code = line.split("//")[0].rstrip()
            if drop_fn and code.startswith(drop_fn):
                skip = True
            if skip:
                depth += code.count("{") - code.count("}")
                if depth == 0 and "}" in code:
                    skip = False
                continue
            if code.strip():
                out.append(code)
    return out


def test_native_source_is_the_jax_packages():
    from desenet_tpu_torch import native

    repo = os.path.dirname(HERE)
    want = _code_lines(os.path.join(repo, "native", "fastops.cpp"))
    got = _code_lines(native.SOURCE)
    assert got == want
    assert any("assemble_batch_s2d4" in ln for ln in got)


def test_native_jpeg_size_reads_the_frame_header(tmp_path):
    """The SOF parse the wrapper sizes its output by, on JPEGs of several
    shapes and with an EXIF block before the frame header."""
    from PIL import Image

    from desenet_tpu_torch import native

    rng = np.random.default_rng(0)
    for i, (h, w) in enumerate([(64, 96), (517, 333), (8, 2000)]):
        p = str(tmp_path / f"{i}.jpg")
        exif = Image.Exif()
        exif[0x0112] = 1
        Image.fromarray(rng.integers(0, 256, (h, w, 3), dtype=np.uint8)).save(
            p, exif=exif)
        with open(p, "rb") as fh:
            data = fh.read()
        assert native.jpeg_size(data) == (h, w)
    assert native.jpeg_size(b"\xff\xd8" + b"\x00" * 32) is None


# ---- data/converters.py, data/misc_tools.py, utils/wandb_offline.py -------


def _voc_and_labelme(root, rng):
    """Pascal-VOC xml and labelme json files made from ``rng`` (one with an
    unknown class, one with a zero-size image, one with no shapes)."""
    import json

    os.makedirs(root)
    names = ["car", "person", "sign", "tree"]
    for i in range(5):
        w, h = (0, 0) if i == 3 else rng.integers(100, 800, 2)
        objs = []
        for _ in range(rng.integers(0, 4)):
            x0, y0 = rng.uniform(0, 90, 2)
            x1, y1 = x0 + rng.uniform(1, 60), y0 + rng.uniform(1, 60)
            objs.append(
                f"<object><name>{names[rng.integers(4)]}</name><bndbox>"
                f"<xmin>{x0:.3f}</xmin><ymin>{y0:.3f}</ymin>"
                f"<xmax>{x1:.3f}</xmax><ymax>{y1:.3f}</ymax></bndbox>"
                "</object>")
        with open(os.path.join(root, f"im{i}.xml"), "w") as f:
            f.write(f"<annotation><size><width>{w}</width><height>{h}"
                    f"</height></size>{''.join(objs)}</annotation>")
        shapes = [{"label": names[rng.integers(4)],
                   "points": rng.uniform(-5, 120, (rng.integers(3, 7), 2))
                   .tolist()} for _ in range(0 if i == 2 else 3)]
        with open(os.path.join(root, f"im{i}.json"), "w") as f:
            json.dump({"imageWidth": 100, "imageHeight": 80,
                       "shapes": shapes}, f)
    with open(os.path.join(root, "notes.txt"), "w") as f:
        f.write("not a label file")


def _files(root):
    out = {}
    for base, _, names in os.walk(root):
        for n in names:
            p = os.path.join(base, n)
            with open(p, "rb") as f:
                out[os.path.relpath(p, root)] = f.read()
    return out


def test_converters_write_the_jax_packages_label_files(tmp_path):
    from desenet_tpu.data import converters as jconv
    from desenet_tpu_torch.data import converters as pconv

    src = str(tmp_path / "src")
    _voc_and_labelme(src, np.random.default_rng(0))
    cmap = {"car": 0, "person": 1, "sign": 2}
    for name in ("voc_xml_to_txt", "labelme_json_to_txt"):
        n_p = getattr(pconv, name)(src, str(tmp_path / "p" / name), cmap)
        n_j = getattr(jconv, name)(src, str(tmp_path / "j" / name), cmap)
        assert n_p == n_j > 0, name
        got, want = (_files(str(tmp_path / k / name)) for k in ("p", "j"))
        assert got == want and len(got) == n_p, name


def _dataset_tree(root, rng):
    """A fake dataset (Images/DeLabels splits, one image of each without
    labels) written with cv2, boxes drawn from ``rng``."""
    import cv2

    for split in ("train", "val"):
        for i in range(4):
            img_dir = os.path.join(root, "Images", split)
            lab_dir = os.path.join(root, "DeLabels", split)
            os.makedirs(img_dir, exist_ok=True)
            os.makedirs(lab_dir, exist_ok=True)
            name = f"sidewalk_{split}{i}"
            im = rng.integers(0, 256, (48 + 8 * i, 64, 3)).astype(np.uint8)
            cv2.imwrite(os.path.join(img_dir, name + ".png"), im)
            if i == 3:
                continue  # an image without labels
            rows = [f"{rng.integers(3)} {rng.uniform(0.2, 0.8):.4f} "
                    f"{rng.uniform(0.2, 0.8):.4f} {rng.uniform(0.1, 0.4):.4f}"
                    f" {rng.uniform(0.1, 0.4):.4f}" for _ in range(2)]
            with open(os.path.join(lab_dir, name + ".txt"), "w") as f:
                f.write("\n".join(rows) + "\n")


@pytest.mark.parametrize("annotated_only", [False, True])
def test_misc_tools_equal(tmp_path, annotated_only):
    import shutil

    from desenet_tpu.data import misc_tools as jmt
    from desenet_tpu_torch.data import misc_tools as pmt

    base = str(tmp_path / "base")
    _dataset_tree(base, np.random.default_rng(0))
    for k in ("p", "j"):
        shutil.copytree(base, str(tmp_path / k / "ds"))
    for mod, k in ((pmt, "p"), (jmt, "j")):
        ds = str(tmp_path / k / "ds")
        images = os.path.join(ds, "Images")
        assert mod.create_folder(str(tmp_path / k / "new")) == str(
            tmp_path / k / "new")
        mod.flatten_recursive(os.path.join(ds, "DeLabels"))
        counts = mod.autosplit(images, weights=(0.5, 0.3, 0.2), seed=3,
                               annotated_only=annotated_only)
        assert sum(counts) == (6 if annotated_only else 8)
        n = mod.extract_boxes(os.path.join(ds, "Images", "train"))
        assert n > 0
        renamed = mod.rename_dataset_prefix(ds, "road")
        assert len(renamed) > 14 and all(
            os.path.basename(new).startswith("road_") for _, new in renamed)
    got, want = (_files(str(tmp_path / k)) for k in ("p", "j"))
    assert sorted(got) == sorted(want)
    for name in want:  # crops are JPEGs that cv2 writes the same
        assert got[name] == want[name], name


def _backend_run(mod, root):
    """The same calls on one package's offline W&B backend."""
    run = mod.init(project="t", name="n", config={"lr0": 0.01, "k": [1, 2]},
                   id="fixed", dir=root, job_type="Training")
    t = mod.Table(["id", "image"])
    img = np.arange(48, dtype=np.uint8).reshape(4, 4, 3)
    t.add_data("a", mod.Image(img, caption="c"))
    t.add_data("b", mod.Image("some/path.jpg"))
    mod.log({"loss": np.float32(0.5), "step": np.int64(3), "table": t})
    run.log({"imgs": [mod.Image(img, masks={"p": {
        "mask_data": np.eye(4, dtype=np.uint8), "class_labels": {0: "x"}}})]},
            step=7)
    src = os.path.join(root, "src")
    os.makedirs(os.path.join(src, "sub"), exist_ok=True)
    with open(os.path.join(src, "sub", "w.bin"), "wb") as f:
        f.write(b"\x01" * 32)
    for v in range(2):
        art = mod.Artifact("m", type="model", metadata={"v": v})
        art.add_dir(src)
        art.add_file(os.path.join(src, "sub", "w.bin"), "top.bin")
        art.add(t, "tbl")
        mod.log_artifact(art, aliases=["latest", f"epoch {v}", ""])
    run.finish()
    return os.path.join(root, "offline-run-fixed")


def test_wandb_offline_writes_the_jax_packages_run(tmp_path):
    import json
    import re

    from desenet_tpu.utils import wandb_offline as joff
    from desenet_tpu_torch.utils import wandb_offline as poff

    media = re.compile(rb"media_\d+_\d+")
    got = _backend_run(poff, str(tmp_path / "p"))
    want = _backend_run(joff, str(tmp_path / "j"))
    gf, wf = _files(got), _files(want)
    norm = lambda d: sorted((media.sub(b"M", k.encode()), media.sub(b"M", v))  # noqa: E731
                            for k, v in d.items())
    assert norm(gf) == norm(wf)
    with open(os.path.join(got, "summary.json")) as f:
        assert json.load(f)["_step"] == 7
    # each package reads the other's artifacts, by alias
    for mod, other in ((poff, want), (joff, got)):
        run = mod.init(project="t", id="reader", dir=os.path.dirname(other))
        art = run.use_artifact("m:epoch 0")
        assert art.metadata == {"v": 0} and art.type == "model"
        with open(os.path.join(art.download(), "top.bin"), "rb") as f:
            assert f.read() == b"\x01" * 32
        assert art.get("tbl").columns == ["id", "image"]
        assert run.use_artifact("m").metadata == {"v": 1}
        assert run.use_artifact("m:nope") is None
        run.finish()
