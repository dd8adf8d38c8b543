"""The port's native host library (``desenet_tpu_torch/native.py`` over
``csrc/host/fastops.cpp``) against the JAX package's (``desenet_tpu.native``
over ``native/fastops.cpp``) and PIL, on the same inputs, on the CPU.

The JAX side is built by its own ``native/Makefile`` into a private
directory and loaded through ``desenet_tpu.native`` pointed there, so that
no other test's build of ``native/libfastops.so`` can race this file's.
The rasterizer is bit-equal on star-shaped and random simple polygons and
to PIL; degenerate polygons take the PIL path; ``decode_jpeg_scaled`` is
byte-equal and rejects non-JPEG input; ``assemble_batch`` equals
``np.stack``; ``MixedDataset(fast_decode=True)`` yields the JAX dataset's
samples for one seed; the image caches ("ram", "disk") yield the uncached
samples; two processes building at once leave one loadable library; a
failed build raises with the compiler's output. Nothing here skips when a
build fails: only the JPEG cases skip, where ``jpeglib.h`` is absent.
"""

import ctypes
import os
import shutil
import subprocess
import sys

import numpy as np
import pytest
from PIL import Image, ImageDraw

import desenet_tpu.native as jax_native
from desenet_tpu.data.dataset import MixedDataset as JaxMixedDataset
from desenet_tpu_torch import native
from desenet_tpu_torch.data import rasterize
from desenet_tpu_torch.data.dataset import MixedDataset, collate
from desenet_tpu_torch.tools.make_fake_dataset import generate

HERE = os.path.dirname(os.path.abspath(__file__))
REPO = os.path.dirname(HERE)
HYP = dict(hsv_h=0.015, hsv_s=0.7, hsv_v=0.4, degrees=5.0, translate=0.1,
           scale=0.5, shear=2.0, perspective=0.0005, flipud=0.5, fliplr=0.5,
           mosaic=1.0, mixup=0.3)


@pytest.fixture(scope="module")
def jax_lib(tmp_path_factory):
    """``desenet_tpu.native`` on a private build of the JAX package's
    library (its Makefile, its source)."""
    d = tmp_path_factory.mktemp("jax_native")
    for f in ("Makefile", "fastops.cpp"):
        shutil.copy(os.path.join(REPO, "native", f), d / f)
    subprocess.run(["make", "-C", str(d)], check=True, capture_output=True)
    mp = pytest.MonkeyPatch()
    mp.setattr(jax_native, "_SO_PATH", str(d / "libfastops.so"))
    mp.setattr(jax_native, "_LIB", None)
    mp.delenv("DESENET_NATIVE", raising=False)
    if not jax_native.available():
        raise RuntimeError("the JAX package's library did not load from "
                           f"{d}")
    yield jax_native
    mp.undo()


def needs_jpeg():
    if not native.has_jpeg_header(native._cxx()):
        pytest.skip("jpeglib.h is absent: the library builds without "
                    "libjpeg")


def pil_rasterize(seg, hw):
    cls = np.zeros(hw, dtype=np.int32)
    for cls_id, pts in seg:
        if len(pts) <= 2:
            continue
        m = Image.new("L", (hw[1], hw[0]), 0)
        ImageDraw.Draw(m).polygon([tuple(p) for p in pts], outline=1, fill=1)
        cls[np.asarray(m, dtype=bool)] = int(cls_id)
    return cls


def star(rng, n, cx, cy, rmin, rmax):
    ang = np.sort(rng.uniform(0, 2 * np.pi, n))
    r = rng.uniform(rmin, rmax, n)
    return np.stack([cx + r * np.cos(ang), cy + r * np.sin(ang)],
                    1).astype(np.float32)


def test_library_builds_and_loads():
    assert native.available()
    assert native.jpeg_available() == native.has_jpeg_header(native._cxx())
    cxx = native._cxx()
    assert os.path.isfile(os.path.join(
        native.build_dir(cxx, native.build_flags(cxx)[0]), native.LIB_NAME))


@pytest.mark.parametrize("shape", [(32, 48, 3), (5, 7), (640, 640, 3)])
def test_assemble_batch_equals_stack(shape, jax_lib):
    rng = np.random.default_rng(len(shape))
    samples = [rng.integers(0, 256, shape, dtype=np.uint8) for _ in range(5)]
    out = native.assemble_batch(samples)
    np.testing.assert_array_equal(out, np.stack(samples, 0))
    np.testing.assert_array_equal(out, jax_lib.assemble_batch(samples))
    # a non-contiguous sample is packed as its values
    strided = [s[::-1] for s in samples]
    np.testing.assert_array_equal(native.assemble_batch(strided),
                                  np.stack(strided, 0))
    with pytest.raises(ValueError, match="differ in shape"):
        native.assemble_batch([samples[0], samples[1][:1]])


def test_raster_star_polygons_bit_equal(jax_lib):
    """Label-like polygons (star-shaped, float coordinates, partly outside
    the image): the port's library, the JAX package's and PIL agree bit for
    bit, and the wrapper always equals PIL."""
    rng = np.random.default_rng(0)
    native_hits = 0
    for _ in range(40):
        pts = star(rng, int(rng.integers(3, 12)), *rng.uniform(-20, 270, 2),
                   8, 60)
        seg = [(1, pts), (2, pts + rng.uniform(-30, 30, 2)),
               (3, np.zeros((2, 2), np.float32))]
        want = pil_rasterize(seg, (256, 256))
        got = native.rasterize_polygons_native(seg, (256, 256))
        ref = jax_lib.rasterize_polygons_native(seg, (256, 256))
        assert (got is None) == (ref is None)
        if got is not None:  # truncation may repeat a vertex
            native_hits += 1
            np.testing.assert_array_equal(got, want)
            np.testing.assert_array_equal(got, ref)
        np.testing.assert_array_equal(
            rasterize.rasterize_polygons(seg, (256, 256)), want)
    assert native_hits >= 25


def test_raster_random_simple_polygons_bit_equal(jax_lib):
    """Random simple polygons with negative and out-of-image coordinates,
    some on integers: exact, on both libraries."""
    rng = np.random.default_rng(1)
    checked = 0
    for _ in range(400):
        pts = rng.uniform(-6, 40, (int(rng.integers(3, 9)), 2)).astype(
            np.float32)
        if rng.random() < 0.4:
            pts = np.round(pts)
        got = native.rasterize_polygons_native([(1, pts)], (32, 32))
        ref = jax_lib.rasterize_polygons_native([(1, pts)], (32, 32))
        assert (got is None) == (ref is None)
        if got is None:  # not simple
            continue
        checked += 1
        np.testing.assert_array_equal(got, pil_rasterize([(1, pts)], (32, 32)))
        np.testing.assert_array_equal(got, ref)
    assert checked > 100


def test_degenerate_polygons_take_the_pil_path(monkeypatch):
    bowtie = np.array([[0, 0], [20, 20], [20, 0], [0, 20]], np.float32)
    square = np.array([[2, 2], [12, 2], [12, 12], [2, 12]], np.float32)
    seg = [(1, square), (2, bowtie)]
    assert native.rasterize_polygons_native(seg, (24, 24)) is None
    want = pil_rasterize(seg, (24, 24))
    np.testing.assert_array_equal(rasterize.rasterize_polygons(seg, (24, 24)),
                                  want)
    assert native.rasterize_polygons_native([], (16, 16)).sum() == 0

    # DESENET_NATIVE_RASTER=0: PIL draws every mask, the library none
    def refuse(*a):
        raise AssertionError("the library drew under DESENET_NATIVE_RASTER=0")

    monkeypatch.setattr(native, "rasterize_polygons_native", refuse)
    monkeypatch.setenv("DESENET_NATIVE_RASTER", "0")
    np.testing.assert_array_equal(
        rasterize.rasterize_polygons([(1, square)], (24, 24)),
        pil_rasterize([(1, square)], (24, 24)))


def write_jpeg(path, w, h, seed=0, exif_orient=None):
    rng = np.random.default_rng(seed)
    small = rng.integers(0, 255, (h // 16 + 1, w // 16 + 1, 3), np.uint8)
    img = Image.fromarray(small).resize((w, h), Image.BILINEAR)
    kw = {"quality": 90}
    if exif_orient is not None:
        exif = Image.Exif()
        exif[0x0112] = exif_orient
        kw["exif"] = exif
    img.save(path, **kw)
    with open(path, "rb") as fh:
        return fh.read()


@pytest.mark.parametrize("wh,target", [((1280, 960), 640), ((320, 240), 640),
                                       ((333, 517), 200), ((96, 64), 64)])
def test_decode_jpeg_scaled_byte_equal(wh, target, jax_lib, tmp_path):
    needs_jpeg()
    data = write_jpeg(str(tmp_path / "a.jpg"), *wh)
    got = native.decode_jpeg_scaled(data, target)
    want = jax_lib.decode_jpeg_scaled(data, target)
    assert got is not None and want is not None
    assert got[1] == want[1] == (wh[1], wh[0])
    assert max(got[0].shape[:2]) >= min(target, max(wh))
    np.testing.assert_array_equal(got[0], want[0])


def test_decode_jpeg_scaled_rejects_non_jpeg(jax_lib):
    needs_jpeg()
    for data in (b"\x89PNG\r\n\x1a\n" + b"0" * 64,
                 b"\xff\xd8\xff\xe0" + b"\x00" * 16, b"\xff"):
        assert native.decode_jpeg_scaled(data, 640) is None
        assert jax_lib.decode_jpeg_scaled(data, 640) is None


def test_opted_out_library_takes_the_python_paths(monkeypatch, tmp_path):
    monkeypatch.setenv("DESENET_NATIVE", "0")
    assert not native.available() and not native.jpeg_available()
    s = [np.full((2, 3), i, np.uint8) for i in range(3)]
    np.testing.assert_array_equal(native.assemble_batch(s), np.stack(s))
    with pytest.raises(RuntimeError, match="DESENET_NATIVE=0"):
        native.decode_jpeg_scaled(b"\xff\xd8\xff", 64)


@pytest.fixture(scope="module")
def jpeg_split(tmp_path_factory):
    """A fake dataset of 160 px JPEGs, trained at 64 px: the scaled decode
    takes the 4/8 scale, then INTER_AREA."""
    root = str(tmp_path_factory.mktemp("native_ds"))
    generate(root, n_train=6, n_val=2, size=160, seed=5)
    return os.path.join(root, "Images", "train")


def samples(ds):
    return [ds.get_sample(i) for i in range(len(ds))]


def assert_samples_equal(got, want):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g[0], w[0])
        np.testing.assert_array_equal(g[1], w[1])
        np.testing.assert_array_equal(g[2], w[2])
        assert g[3] == w[3]


@pytest.mark.parametrize("augment", [False, True])
def test_fast_decode_dataset_matches_jax(augment, jax_lib, jpeg_split):
    needs_jpeg()
    kw = dict(img_size=64, batch_size=2, augment=augment,
              hyp=HYP if augment else None, seed=3)
    got = samples(MixedDataset(jpeg_split, fast_decode=True, **kw))
    want = samples(JaxMixedDataset(jpeg_split, fast_decode=True, **kw))
    assert_samples_equal(got, want)
    # the scaled decode is not PIL's: the option changes the pixels
    plain = samples(MixedDataset(jpeg_split, **kw))
    assert any(not np.array_equal(g[0], p[0]) for g, p in zip(got, plain))


def test_fast_decode_takes_pil_for_what_it_does_not_decode(tmp_path):
    """A PNG and an EXIF-rotated JPEG go through PIL, as in the JAX
    package; a corrupt JPEG too."""
    needs_jpeg()
    ds = MixedDataset.__new__(MixedDataset)
    ds.img_size, ds.fast_decode, ds.im_cache = 64, True, None
    png = str(tmp_path / "a.png")
    Image.fromarray(np.zeros((80, 96, 3), np.uint8)).save(png)
    rot = str(tmp_path / "r.jpg")
    write_jpeg(rot, 96, 80, exif_orient=6)
    bad = str(tmp_path / "b.jpg")
    with open(bad, "wb") as fh:
        fh.write(b"\xff\xd8\xff\xe0" + b"\x00" * 64)
    for p in (png, rot, bad):
        assert ds._load_image_fast(p) is None
    ok = str(tmp_path / "ok.jpg")
    write_jpeg(ok, 96, 80)
    arr, hw0, hw = ds._load_image_fast(ok)
    assert hw0 == (80, 96) and hw == arr.shape[:2] == (53, 64)


def test_fast_decode_without_libjpeg_raises(monkeypatch, jpeg_split):
    monkeypatch.setattr(native, "jpeg_available", lambda: False)
    with pytest.raises(RuntimeError, match="libjpeg"):
        MixedDataset(jpeg_split, img_size=64, fast_decode=True)


@pytest.mark.parametrize("mode", ["ram", "disk"])
@pytest.mark.parametrize("augment", [False, True])
def test_image_cache_yields_uncached_samples(mode, augment, jpeg_split):
    kw = dict(img_size=64, batch_size=2, augment=augment,
              hyp=HYP if augment else None, seed=4)
    ds = MixedDataset(jpeg_split, cache_images=mode, **kw)
    assert all(c is not None for c in ds.im_cache)
    assert_samples_equal(samples(ds), samples(MixedDataset(jpeg_split, **kw)))
    if mode == "disk":
        root = os.path.dirname(os.path.dirname(jpeg_split))
        cdir = os.path.join(root, "DeLabels", "train.imgcache")
        assert len([f for f in os.listdir(cdir) if f.endswith(".npy")]) == 6
        # a second dataset reads the files written by the first
        again = MixedDataset(jpeg_split, cache_images=mode, **kw)
        assert_samples_equal(samples(again), samples(ds))
    with pytest.raises(ValueError, match="cache_images"):
        MixedDataset(jpeg_split, img_size=64, cache_images="gpu")


def test_collate_packs_through_the_library(monkeypatch, jpeg_split):
    ds = MixedDataset(jpeg_split, img_size=64, batch_size=3)
    batch = [ds.get_sample(i) for i in range(3)]
    calls = []
    real = native.assemble_batch
    monkeypatch.setattr(native, "assemble_batch",
                        lambda s: calls.append(len(s)) or real(s))
    out = collate(batch, 8)
    assert calls == [3]
    np.testing.assert_array_equal(out["image"], np.stack([b[0] for b in
                                                          batch]))


BUILD = """
import sys
from desenet_tpu_torch import native
native.BUILD_ROOT = sys.argv[1]
print(native.build())
"""


def test_concurrent_builds_leave_one_loadable_library(tmp_path):
    env = dict(os.environ, PYTHONPATH=REPO)
    procs = [subprocess.Popen([sys.executable, "-c", BUILD, str(tmp_path)],
                              env=env, stdout=subprocess.PIPE,
                              stderr=subprocess.PIPE, text=True)
             for _ in range(3)]
    outs = [p.communicate(timeout=120) for p in procs]
    assert all(p.returncode == 0 for p in procs), outs
    paths = {o[0].strip() for o in outs}
    assert len(paths) == 1
    (so,) = paths
    build = os.path.dirname(so)
    assert sorted(os.listdir(build)) == sorted(
        ["build.log", "lock", native.LIB_NAME])
    assert ctypes.CDLL(so).fastops_version() == native.VERSION


def test_failed_build_raises_with_the_compiler_output(monkeypatch, tmp_path):
    bad = tmp_path / "fastops.cpp"
    bad.write_text("this is not C++\n")
    monkeypatch.setattr(native, "SOURCE", str(bad))
    monkeypatch.setattr(native, "BUILD_ROOT", str(tmp_path / "build"))
    with pytest.raises(RuntimeError, match="error"):
        native.build()
