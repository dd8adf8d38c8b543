"""The port's drawing, plotting and input-source utilities
(``utils/plots.py``, ``data/sources.py``, ``utils/general.py``'s
``save_one_box`` and ``colorstr``) against the JAX package's, on the CPU.

``Annotator``, ``SegAnnotator``, ``plot_images`` and ``save_one_box`` give
byte-equal images; ``output_to_target`` and ``segoutput_to_target`` equal
arrays (the port's seg logits NCHW, JAX's NHWC); the matplotlib plots write
the same files; ``visualize_model_features`` gives the JAX model's captured
per-row maps (NHWC, in its order) within 1e-4 of their largest magnitude
and as many feature grids; ``LoadImages`` yields the same (path, image,
native image) over two images and a 3-frame mp4, and ``LoadStreams`` reads
a clip and a ``.txt`` list of two, as tests/test_sources_stream.py does.
"""

import os

import cv2
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import traverse_util

import torch_detect_case as D
from desenet_tpu.data import sources as jax_sources
from desenet_tpu.ops.nms import NMSOutput as JaxNMSOutput
from desenet_tpu.utils import general as jax_general
from desenet_tpu.utils import plots as jax_plots
from desenet_tpu_torch.data import sources
from desenet_tpu_torch.ops import NMSOutput
from desenet_tpu_torch.utils import general, plots


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    yield from D.one_thread()


def image(rng, h=96, w=128):
    return rng.integers(0, 256, (h, w, 3), dtype=np.uint8)


def test_palettes_annotators_and_crops_are_byte_equal(tmp_path):
    rng = np.random.default_rng(0)
    assert [plots.colors(i, bgr) for i in range(25) for bgr in (0, 1)] == \
        [jax_plots.colors(i, bgr) for i in range(25) for bgr in (0, 1)]
    np.testing.assert_array_equal(plots.label_colormap(),
                                  jax_plots.label_colormap())
    im = image(rng)
    boxes = [(5, 6, 60, 70, "car 0.91"), (40, 2, 120, 40, ""),
             (0, 50, 30, 95, "person")]
    drawn = []
    for mod in (plots, jax_plots):
        ann = mod.Annotator(im.copy(), line_width=None)
        for *b, label in boxes:
            ann.box_label(b, label, mod.colors(len(label), True))
        drawn.append(ann.result())
    np.testing.assert_array_equal(*drawn)
    mask = rng.integers(0, 4, im.shape[:2]).astype(np.uint8)
    seg = [mod.SegAnnotator() for mod in (plots, jax_plots)]
    np.testing.assert_array_equal(seg[0].overlay(im, mask),
                                  seg[1].overlay(im, mask))
    for mod, s in zip(("port", "jax"), seg):
        s.save_mask(mask, str(tmp_path / f"{mod}_mask.png"))
    np.testing.assert_array_equal(cv2.imread(str(tmp_path / "port_mask.png")),
                                  cv2.imread(str(tmp_path / "jax_mask.png")))
    for kw in (dict(), dict(square=True), dict(BGR=False, gain=1.2, pad=0)):
        got = general.save_one_box((10.4, 20.7, 70.2, 90.9), im,
                                   file=str(tmp_path / "p" / "c.jpg"), **kw)
        want = jax_general.save_one_box((10.4, 20.7, 70.2, 90.9), im,
                                        file=str(tmp_path / "j" / "c.jpg"),
                                        **kw)
        np.testing.assert_array_equal(got, want)
        np.testing.assert_array_equal(cv2.imread(str(tmp_path / "p/c.jpg")),
                                      cv2.imread(str(tmp_path / "j/c.jpg")))
    assert general.colorstr("red", "bold", "x") == \
        jax_general.colorstr("red", "bold", "x")
    assert general.colorstr("y") == jax_general.colorstr("y")


def test_targets_and_plot_images_match_jax(tmp_path):
    rng = np.random.default_rng(1)
    b, m = 3, 5
    boxes = rng.uniform(0, 60, (b, m, 4)).astype(np.float32)
    boxes[..., 2:] += boxes[..., :2]
    scores = rng.uniform(0, 1, (b, m)).astype(np.float32)
    classes = rng.integers(0, 3, (b, m)).astype(np.float32)
    num = np.asarray([0, 3, 5], np.int32)
    valid = np.arange(m)[None] < num[:, None]
    got = plots.output_to_target(NMSOutput(*(torch.from_numpy(a) for a in (
        boxes, scores, classes, valid, num))))
    want = jax_plots.output_to_target(JaxNMSOutput(
        *(jnp.asarray(a) for a in (boxes, scores, classes, valid, num))))
    np.testing.assert_array_equal(got, want)
    assert got.shape == (8, 7)
    logits = rng.normal(0, 1, (2, 12, 16, 3)).astype(np.float32)
    for hw in ((12, 16), (48, 64)):
        np.testing.assert_array_equal(
            plots.segoutput_to_target(
                torch.from_numpy(logits).permute(0, 3, 1, 2), hw),
            jax_plots.segoutput_to_target(logits, hw))
    imgs = np.stack([image(rng, 64, 64) for _ in range(b)])
    targets = np.concatenate([got[:, :2], got[:, 2:6] / 64, got[:, 6:]], 1)
    segm = rng.integers(0, 3, (b, 64, 64))
    for mod, name in ((plots, "port"), (jax_plots, "jax")):
        mod.plot_images(imgs, targets, segm, [f"a/{i}.jpg" for i in range(b)],
                        fname=str(tmp_path / f"{name}.jpg"),
                        seg_fname=str(tmp_path / f"{name}_seg.jpg"),
                        names={0: "car", 1: "person"}, max_size=160)
    for suffix in ("", "_seg"):
        got_im = cv2.imread(str(tmp_path / f"port{suffix}.jpg"))
        np.testing.assert_array_equal(
            got_im, cv2.imread(str(tmp_path / f"jax{suffix}.jpg")))


def test_matplotlib_plots_write_jax_files(tmp_path):
    pytest.importorskip("matplotlib")
    rng = np.random.default_rng(2)
    labels = [np.concatenate([rng.integers(0, 3, (6, 1)),
                              rng.uniform(0, 1, (6, 4))], 1)
              for _ in range(3)]
    csv = tmp_path / "results.csv"
    csv.write_text("epoch,loss,map\n0,1.5,0.1\n1,1.2,0.3\n2,1.0,\n")
    evolve = tmp_path / "evolve.csv"
    evolve.write_text("fitness,lr0,momentum\n0.1,0.01,0.9\n0.2,0.02,0.95\n")
    x = rng.normal(0, 1, (1, 8, 8, 12)).astype(np.float32)
    for mod, name in ((plots, "port"), (jax_plots, "jax")):
        d = tmp_path / name
        d.mkdir()
        outs = [mod.plot_labels(labels, ["a", "b", "c"], str(d)),
                mod.plot_lr_scheduler(lambda e: 0.01 * (1 - e / 5), 5, str(d)),
                mod.plot_evolve(str(evolve), str(d / "evolve.png")),
                mod.feature_visualization(x, "C3", 2, save_dir=str(d)),
                mod.feature_visualization(x[0], "C3", 3, save_dir=str(d))]
        mod.plot_results(str(csv), str(d / "results.png"))
        assert outs[-1] is None and all(os.path.isfile(o) for o in outs[:-1])
    assert sorted(os.listdir(tmp_path / "port")) == \
        sorted(os.listdir(tmp_path / "jax"))


def test_visualize_model_features_matches_jax(tmp_path):
    pytest.importorskip("matplotlib")
    jm, jv = D.jax_variables(D.member_weights(0), seg_upsample=False)
    pm = D.port_model(0, seg_upsample=False)
    x = np.random.default_rng(3).uniform(0, 1, (1, 64, 64, 3)).astype(
        np.float32)
    # the JAX package's capture, as its visualize_model_features takes it
    _, mods = jax.jit(lambda v, a: jm.apply(
        v, a, train=False, capture_intermediates=lambda m, n: n == "__call__",
        mutable=["intermediates"]))(jv, jnp.asarray(x))
    inter = traverse_util.flatten_dict(mods["intermediates"])
    want = []
    for path, val in sorted(inter.items(), key=lambda kv: "/".join(kv[0])):
        arr = val[0][0] if isinstance(val[0], (tuple, list)) else val[0]
        if len(path) == 2 and getattr(arr, "ndim", 0) == 4:
            want.append((path[0], np.asarray(arr, np.float32)))
    got = plots.feature_maps(pm, torch.from_numpy(x).permute(0, 3, 1, 2))
    assert [n for n, _ in got] == [n for n, _ in want] and len(got) > 15
    for (name, g), (_, w) in zip(got, want):
        assert g.shape == w.shape, name
        assert np.abs(g - w).max() <= 1e-4 * max(np.abs(w).max(), 1.0), name
    outs = plots.visualize_model_features(
        pm, torch.from_numpy(x).permute(0, 3, 1, 2),
        save_dir=str(tmp_path / "port"), max_layers=2)
    jouts = jax_plots.visualize_model_features(
        jm, jv, x, save_dir=str(tmp_path / "jax"), max_layers=2)
    assert len(outs) == len(jouts) == 2
    assert sorted(os.listdir(tmp_path / "port")) == \
        sorted(os.listdir(tmp_path / "jax"))


@pytest.fixture(scope="module")
def media(tmp_path_factory):
    d = tmp_path_factory.mktemp("media")
    rng = np.random.default_rng(4)
    cv2.imwrite(str(d / "a.png"), image(rng, 50, 70))
    cv2.imwrite(str(d / "b.jpg"), image(rng, 80, 60))
    clip = str(d / "clip.mp4")
    w = cv2.VideoWriter(clip, cv2.VideoWriter_fourcc(*"mp4v"), 30.0,
                        (96, 64))
    if not w.isOpened():
        pytest.skip("cv2 build lacks the mp4v encoder")
    for _ in range(3):
        w.write(image(rng, 64, 96))
    w.release()
    return d, clip


def test_load_images_yields_jax_frames(media):
    d, _ = media
    for src in (str(d), str(d / "*.p*"), str(d / "clip.mp4")):
        got = sources.LoadImages(src, img_size=64, stride=32)
        want = jax_sources.LoadImages(src, img_size=64, stride=32)
        assert len(got) == len(want)
        rows = 0
        for (gp, gi, g0, gc), (wp, wi, w0, wc) in zip(got, want):
            assert gp == wp and got.mode == want.mode
            np.testing.assert_array_equal(gi, wi)
            np.testing.assert_array_equal(g0, w0)
            assert (gc is None) == (wc is None)
            rows += 1
        assert rows == {0: 5, 1: 1, 2: 3}[(src.endswith("*.p*"))
                                         + 2 * src.endswith("mp4")]
    with pytest.raises(FileNotFoundError):
        sources.LoadImages(str(d / "missing"))


def test_load_streams_reads_a_clip_and_a_list(media, tmp_path):
    _, clip = media
    s = sources.LoadStreams(clip, img_size=64, stride=32)
    assert len(s) == 1
    it = iter(s)
    for _ in range(2):
        srcs, imgs, im0, cap = next(it)
        assert srcs == [clip] and cap is None
        assert imgs.shape == (1, 64, 64, 3) and im0[0].shape == (64, 96, 3)
    lst = tmp_path / "streams.txt"
    lst.write_text(f"{clip}\n{clip}\n")
    s = sources.LoadStreams(str(lst), img_size=64, stride=32)
    _, imgs, im0, _ = next(iter(s))
    assert len(s) == 2 and imgs.shape[0] == 2 and len(im0) == 2
