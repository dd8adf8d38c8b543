"""The port's training data pipeline against the JAX package's, on the CPU:
augmented samples byte-equal, the augmentation functions alone, the
collates and the training loader's per-epoch batches.

The data is a ``tools/make_fake_dataset.py`` split (64 px; some images
resized to other aspect ratios, so the letterbox pads and the mosaic tiles
differ in shape). Images and seg masks must be equal; det labels within
1e-6 (the same float32 numpy arithmetic, so in practice equal too).
Needs cv2 and PIL.
"""

import os
import sys

import numpy as np
import pytest
import torch

from desenet_tpu.data import augment as jax_aug
from desenet_tpu.data import dataset as jax_ds
from desenet_tpu.data import loader as jax_loader
from desenet_tpu_torch.data import augment as port_aug
from desenet_tpu_torch.data import dataset as port_ds
from desenet_tpu_torch.data import loader as port_loader

HERE = os.path.dirname(os.path.abspath(__file__))
DET_TOL = 1e-6

# every branch of get_sample: mosaic (4 and 9), mixup, the warp with
# rotation, shear and perspective, both flips, HSV
ALL_ON = dict(mosaic=1.0, mosaic9=0.4, mixup=0.5, degrees=10.0,
              translate=0.1, scale=0.3, shear=5.0, perspective=0.0005,
              flipud=0.5, fliplr=0.5, hsv_h=0.05, hsv_s=0.3, hsv_v=0.2)
HYPS = {
    "all_on": ALL_ON,
    "half_mosaic": dict(ALL_ON, mosaic=0.5, mosaic9=0.0),
    "letterbox_only": dict(ALL_ON, mosaic=0.0, perspective=0.0),
    "recipe": None,  # the engine's DEFAULT_HYP, filled in below
}


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """One intra-op thread: as fast on these tiny tensors, and the parallel
    test workers then do not oversubscribe the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def split(tmp_path_factory):
    cv2 = pytest.importorskip("cv2", reason="the fake dataset and the "
                              "augmentations need cv2")
    pytest.importorskip("PIL", reason="the loaders decode images with PIL")
    sys.path.insert(0, os.path.join(os.path.dirname(HERE), "tools"))
    from make_fake_dataset import generate

    root = tmp_path_factory.mktemp("fakeds_aug")
    generate(str(root), n_train=8, n_val=1, size=64, de_nc=3, se_nc=2,
             seed=4)
    train = os.path.join(str(root), "Images", "train")
    for i, name in enumerate(sorted(os.listdir(train))):
        if i % 3:
            path = os.path.join(train, name)
            size = (96, 54) if i % 3 == 1 else (48, 80)
            cv2.imwrite(path, cv2.resize(cv2.imread(path), size))
    return train


def hyp_of(name):
    from desenet_tpu_torch.train.engine import DEFAULT_HYP

    return dict(DEFAULT_HYP) if HYPS[name] is None else HYPS[name]


def assert_samples_equal(got, want, what):
    (gi, gd, gs, gp, gsh), (wi, wd, ws, wp, wsh) = got, want
    assert gi.dtype == wi.dtype and gi.shape == wi.shape, what
    np.testing.assert_array_equal(gi, wi, err_msg=what)
    np.testing.assert_array_equal(gs, ws, err_msg=what)
    assert gd.dtype == wd.dtype and gd.shape == wd.shape, what
    if len(wd):
        np.testing.assert_allclose(gd, wd, rtol=0, atol=DET_TOL, err_msg=what)
    assert gp == wp and repr(gsh) == repr(wsh), what


@pytest.mark.parametrize("name", sorted(HYPS))
def test_augmented_samples_equal(split, name):
    """Three epochs, every position, one dataset of each package."""
    kw = dict(img_size=64, augment=True, hyp=hyp_of(name), seed=3)
    got, want = port_ds.MixedDataset(split, **kw), jax_ds.MixedDataset(
        split, **kw)
    assert got.mosaic == want.mosaic
    for epoch in range(3):
        got.set_epoch(epoch)
        want.set_epoch(epoch)
        for pos in range(len(want)):
            assert_samples_equal(got.get_sample(pos), want.get_sample(pos),
                                 f"{name} epoch {epoch} position {pos}")


@pytest.mark.parametrize("rect,single_cls", [(True, False), (False, True)])
def test_augmented_rect_and_single_cls_equal(split, rect, single_cls):
    kw = dict(img_size=64, augment=True, hyp=ALL_ON, rect=rect,
              single_cls=single_cls, batch_size=3, seed=1)
    got, want = port_ds.MixedDataset(split, **kw), jax_ds.MixedDataset(
        split, **kw)
    assert not got.mosaic if rect else got.mosaic
    for pos in range(len(want)):
        assert_samples_equal(got.get_sample(pos), want.get_sample(pos),
                             f"rect={rect} position {pos}")


def test_resample_equal(split):
    kw = dict(img_size=64, augment=True, hyp=ALL_ON)
    got, want = port_ds.MixedDataset(split, **kw), jax_ds.MixedDataset(
        split, **kw)
    w = np.arange(1, len(want) + 1, dtype=np.float64)
    got.resample(w, np.random.default_rng(5))
    want.resample(w, np.random.default_rng(5))
    np.testing.assert_array_equal(got.indices, want.indices)
    assert_samples_equal(got.get_sample(0), want.get_sample(0), "resampled")


def images(seed, n=1, shape=(48, 80, 3)):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, 256, shape, dtype=np.uint8) for _ in range(n)]


def boxes(rng, n, w, h):
    xy = rng.uniform(0, [w * 0.7, h * 0.7], (n, 2))
    wh = rng.uniform(4, [w * 0.3, h * 0.3], (n, 2))
    return np.concatenate([rng.integers(0, 3, (n, 1)), xy, xy + wh],
                          1).astype(np.float32)


def polys(rng, n, w, h):
    return [(int(rng.integers(0, 3)),
             rng.uniform(0, [w, h], (int(rng.integers(3, 7)), 2))
             .astype(np.float32)) for _ in range(n)]


@pytest.mark.parametrize("kw", [
    dict(new_shape=64), dict(new_shape=64, auto=True),
    dict(new_shape=(64, 96), scale_fill=True), dict(new_shape=32,
                                                     scaleup=False),
    dict(new_shape=(96, 64), auto=True, stride=16, color=(0, 50, 200)),
    dict(new_shape=128, scaleup=False)])
def test_letterbox_equal(kw):
    pytest.importorskip("cv2")
    (img,) = images(0)
    got, want = port_aug.letterbox(img, **kw), jax_aug.letterbox(
        img, **{"auto": False, **kw})
    np.testing.assert_array_equal(got[0], want[0])
    assert got[1:] == want[1:]


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_hsv_and_flips_and_mixup_equal(seed):
    pytest.importorskip("cv2")
    a, b = images(seed, 2)
    got = port_aug.augment_hsv(a.copy(), np.random.default_rng(seed),
                               0.05, 0.4, 0.3)
    want = jax_aug.augment_hsv(a.copy(), np.random.default_rng(seed),
                               0.05, 0.4, 0.3)
    np.testing.assert_array_equal(got, want)
    rng = np.random.default_rng(seed)
    det = np.concatenate([rng.integers(0, 3, (4, 1)),
                          rng.uniform(0.2, 0.8, (4, 4))], 1).astype(np.float32)
    seg = polys(rng, 3, 80, 48)
    for flip in ("flip_ud", "flip_lr"):
        gi, gd, gs = getattr(port_aug, flip)(a, det.copy(), seg)
        wi, wd, ws = getattr(jax_aug, flip)(a, det.copy(), seg)
        np.testing.assert_array_equal(gi, wi)
        np.testing.assert_array_equal(gd, wd)
        for (gc, gp), (wc, wp) in zip(gs, ws):
            assert gc == wc
            np.testing.assert_array_equal(gp, wp)
    gm = port_aug.mixup(a, det, seg, b, det[:2], seg[:1],
                        np.random.default_rng(seed))
    wm = jax_aug.mixup(a, det, seg, b, det[:2], seg[:1],
                       np.random.default_rng(seed))
    np.testing.assert_array_equal(gm[0], wm[0])
    np.testing.assert_array_equal(gm[1], wm[1])
    assert len(gm[2]) == len(wm[2]) == 4


@pytest.mark.parametrize("perspective,border", [(0.0, (0, 0)),
                                                (0.001, (0, 0)),
                                                (0.0, (-24, -40))])
def test_random_perspective_and_box_candidates_equal(perspective, border):
    pytest.importorskip("cv2")
    (img,) = images(7)
    rng = np.random.default_rng(11)
    det, seg = boxes(rng, 6, 80, 48), polys(rng, 3, 80, 48)
    kw = dict(degrees=15.0, translate=0.2, scale=0.4, shear=8.0,
              perspective=perspective, border=border)
    got = port_aug.random_perspective(img, det.copy(), seg,
                                      np.random.default_rng(3), **kw)
    want = jax_aug.random_perspective(img, det.copy(), seg,
                                      np.random.default_rng(3), **kw)
    np.testing.assert_array_equal(got[0], want[0])
    np.testing.assert_array_equal(got[1], want[1])
    for (gc, gp), (wc, wp) in zip(got[2], want[2]):
        assert gc == wc
        np.testing.assert_array_equal(gp, wp)
    before, after = boxes(rng, 50, 80, 48)[:, 1:5].T, \
        boxes(rng, 50, 80, 48)[:, 1:5].T
    np.testing.assert_array_equal(port_aug.box_candidates(before, after),
                                  jax_aug.box_candidates(before, after))


@pytest.mark.parametrize("seed", [0, 1])
def test_cutout_hist_equalize_replicate_equal(seed):
    pytest.importorskip("cv2")
    (img,) = images(seed, shape=(64, 64, 3))
    rng = np.random.default_rng(seed)
    det = boxes(rng, 5, 64, 64)
    got = port_aug.cutout(img.copy(), det.copy(), np.random.default_rng(seed))
    want = jax_aug.cutout(img.copy(), det.copy(), np.random.default_rng(seed))
    np.testing.assert_array_equal(got[0], want[0])
    np.testing.assert_array_equal(got[1], want[1])
    for clahe in (True, False):
        for bgr in (True, False):
            np.testing.assert_array_equal(
                port_aug.hist_equalize(img, clahe, bgr),
                jax_aug.hist_equalize(img, clahe, bgr))
    got = port_aug.replicate_labels(img.copy(), det.copy(),
                                    np.random.default_rng(seed))
    want = jax_aug.replicate_labels(img.copy(), det.copy(),
                                    np.random.default_rng(seed))
    np.testing.assert_array_equal(got[0], want[0])
    np.testing.assert_array_equal(got[1], want[1])


def samples(split, n, seed=0):
    ds = port_ds.MixedDataset(split, img_size=64, augment=True, hyp=ALL_ON,
                              seed=seed)
    return [ds.get_sample(i % len(ds)) for i in range(n)]


def assert_batches_equal(got, want):
    assert set(got) == set(want)
    for k in ("image", "det_targets", "det_mask", "seg_labels"):
        g = np.asarray(got[k])
        assert g.dtype == want[k].dtype, k
        np.testing.assert_array_equal(g, want[k], err_msg=k)
    assert got["paths"] == want["paths"]
    assert repr(got["shapes"]) == repr(want["shapes"])


@pytest.mark.parametrize("seed", [0, 1, 2, 3])
def test_collates_equal(split, seed):
    s = samples(split, 8, seed)
    assert_batches_equal(port_ds.collate(s, 16), jax_ds.collate(s, 16))
    assert_batches_equal(
        port_ds.collate_quad(s, 16, rng=np.random.default_rng(seed)),
        jax_ds.collate_quad(s, 16, rng=np.random.default_rng(seed)))
    with pytest.raises(ValueError, match="multiple of 4"):
        port_ds.collate_quad(s[:6], 16)


@pytest.mark.parametrize("quad,rank,world", [(False, 0, 1), (True, 0, 1),
                                             (False, 1, 2)])
def test_train_loader_batches_equal(split, quad, rank, world):
    """The training loader (shuffled, drop_last, augmented) batch by batch
    over three epochs, with the quad collate and a strided shard."""
    kw = dict(img_size=64, batch_size=4 if quad or world > 1 else 3,
              augment=True, hyp=ALL_ON, workers=2, max_targets=16, seed=2,
              quad=quad, rank=rank, world_size=world)
    (gl, _), (wl, _) = port_loader.create_mixed_dataloader(split, **kw), \
        jax_loader.create_mixed_dataloader(split, **kw)
    assert len(gl) == len(wl) > 0
    for epoch in range(3):
        gl.set_epoch(epoch)
        wl.set_epoch(epoch)
        np.testing.assert_array_equal(gl._epoch_positions(),
                                      wl._epoch_positions())
        got, want = list(gl), list(wl)
        assert len(got) == len(want) == len(wl)
        for g, w in zip(got, want):
            assert_batches_equal(g, w)


def test_stage_to_device_and_refused_decode(split, monkeypatch):
    """The stage callback hands the step tensors (on the CPU here, so no
    pinned copy); the scaled decode without libjpeg in the native library
    and an unknown image-cache mode are refused
    (tests/test_torch_native.py holds both options against the JAX
    package)."""
    import torch

    (loader, _) = port_loader.create_mixed_dataloader(
        split, img_size=64, batch_size=4, augment=True, hyp=ALL_ON,
        workers=1, stage=port_loader.to_device("cpu"))
    batch = next(iter(loader))
    assert all(isinstance(batch[k], torch.Tensor) for k in
               port_loader.ARRAY_KEYS)
    assert batch["image"].dtype == torch.uint8 and batch["paths"]
    with pytest.raises(ValueError, match="cache_images"):
        port_loader.create_mixed_dataloader(split, augment=True,
                                            cache_images="gpu")
    from desenet_tpu_torch import native

    monkeypatch.setattr(native, "jpeg_available", lambda: False)
    with pytest.raises(RuntimeError, match="libjpeg"):
        port_loader.create_mixed_dataloader(split, augment=True,
                                            fast_decode=True)
