"""The joint detection+segmentation dataset ("mixed" pipeline).

The port's own copy of ``desenet_tpu/data/dataset.py``: directory/txt
listing, sibling ``DeLabels/`` + ``SeLabels/`` label dirs, per-sample
validation, the label cache with content hashing (the same pickle, so either
package reads the other's), letterbox, rect mode with aspect-sorted
per-batch shapes, polygon rasterizing and COCO-rescaling ``shapes``
metadata, and for training (``augment=True``) mosaic (4 and 9 images),
mixup, the random perspective warp, HSV jitter and flips. Each sample's
augmentation draws from its own generator, seeded by (seed, epoch, index),
so a sample is the same bytes in either package and in any order.
``fast_decode`` decodes JPEGs with the native library's scaled libjpeg
decode (``native.decode_jpeg_scaled``, not pixel-equal to PIL, so it is
opt-in; without libjpeg in the library it raises), ``cache_images``
("ram" or "disk") decodes each image once, and ``collate`` packs images
with ``native.assemble_batch``. numpy and the standard library at module
level; PIL is imported where an image is opened, cv2 where one is resized
or warped.

Label formats:
  DeLabels/<split>/x.txt : lines "cls x y w h" normalized xywh
  SeLabels/<split>/x.txt : lines "cls x1 y1 x2 y2 ..." normalized polygon
"""

from __future__ import annotations

import hashlib
import logging
import os
import pickle
from multiprocessing.pool import ThreadPool
from pathlib import Path
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from desenet_tpu_torch.data.augment import (PAD_VALUE, augment_hsv,
                                            denorm_boxes, denorm_polys,
                                            flip_lr, flip_ud, letterbox,
                                            mixup, random_perspective)
from desenet_tpu_torch.data.rasterize import rasterize_polygons

LOGGER = logging.getLogger(__name__)

IMG_FORMATS = {"bmp", "jpg", "jpeg", "png", "tif", "tiff", "dng", "webp", "mpo"}
CACHE_VERSION = 1
NUM_THREADS = min(8, os.cpu_count() or 1)


def _require(ok, msg: str) -> None:
    """Raise on a corrupt sample (verify_image_label turns it into a skip)."""
    if not ok:
        raise ValueError(msg)


def img2label_paths(img_paths: Sequence[str]) -> Tuple[List[str], List[str]]:
    """image path -> (DeLabels, SeLabels) txt paths."""
    de, se = [], []
    for x in img_paths:
        p = Path(x)
        name = p.with_suffix(".txt").name
        de.append(str(p.parent.parent.with_name("DeLabels") / p.parent.name / name))
        se.append(str(p.parent.parent.with_name("SeLabels") / p.parent.name / name))
    return de, se


def get_hash(paths: Sequence[str]) -> str:
    """Content hash over file sizes + joined names."""
    size = sum(os.path.getsize(p) for p in paths if os.path.exists(p))
    h = hashlib.md5(str(size).encode())
    h.update("".join(paths).encode())
    return h.hexdigest()


def exif_size(img) -> Tuple[int, int]:
    """(w, h) corrected for EXIF rotation."""
    s = img.size
    try:
        rot = dict(img.getexif()).get(274, None)
        if rot in (6, 8):
            s = (s[1], s[0])
    except Exception:
        pass
    return s


def verify_image_label(args):
    """Validate one (image, det txt, seg txt) triple; returns parsed labels
    or None on corruption."""
    from PIL import Image

    im_file, dlb, slb = args
    try:
        with Image.open(im_file) as im:
            im.verify()
            shape = exif_size(im)
            fmt = (im.format or "").lower()
            _require(fmt in IMG_FORMATS, f"unsupported format {fmt}")
            _require(shape[0] > 9 and shape[1] > 9,
                     f"image too small {shape}")

        det = np.zeros((0, 5), np.float32)
        nm = nf = ne = 0
        if os.path.isfile(dlb):
            nf = 1
            with open(dlb) as f:
                rows = [x.split() for x in f.read().strip().splitlines() if x]
            if rows:
                det = np.asarray(rows, np.float32)
                _require(det.shape[1] == 5, "det rows must have 5 values")
                _require((det >= 0).all(), "negative det values")
                _require((det[:, 1:] <= 1).all(), "det coords not normalized")
                _require(np.unique(det, axis=0).shape[0] == det.shape[0],
                         "duplicate det rows")
            else:
                ne = 1
        else:
            nm = 1

        seg: List[Tuple[int, np.ndarray]] = []
        if os.path.isfile(slb):
            with open(slb) as f:
                for line in f.read().strip().splitlines():
                    vals = np.asarray(line.split(), np.float32)
                    _require((vals >= 0).all(), "negative seg values")
                    _require((vals[1:] <= 1).all(),
                             "seg coords not normalized")
                    seg.append((int(vals[0]), vals[1:].reshape(-1, 2)))
        return im_file, det, seg, shape, nm, nf, ne, 0, ""
    except Exception as e:  # noqa: BLE001 — corrupt samples are skipped
        return None, None, None, None, 0, 0, 0, 1, f"skipping {im_file}: {e}"


class MixedDataset:
    def __init__(
        self,
        path,
        img_size: int = 640,
        batch_size: int = 16,
        augment: bool = False,
        hyp: Optional[Dict] = None,
        rect: bool = False,
        stride: int = 32,
        pad: float = 0.0,
        single_cls: bool = False,
        max_targets: int = 128,
        seed: int = 0,
        prefix: str = "",
        fast_decode: bool = False,
        cache_images: Optional[str] = None,
    ):
        if cache_images not in (None, "ram", "disk"):
            raise ValueError(f"cache_images={cache_images!r}: 'ram', 'disk' "
                             "or None")
        if fast_decode:
            require_fast_decode()
        self.fast_decode = fast_decode
        self.img_size = img_size
        self.batch_size = batch_size
        self.augment = augment
        self.hyp = dict(hyp or {})
        self.rect = rect
        self.mosaic = augment and not rect and self.hyp.get("mosaic", 0) > 0
        self.mosaic_border = (-img_size // 2, -img_size // 2)
        self.stride = stride
        self.pad = pad
        self.max_targets = max_targets
        self.seed = seed
        self.epoch = 0

        # ---- file listing (dir / txt / list of either) ----
        files: List[Path] = []
        for p in path if isinstance(path, (list, tuple)) else [path]:
            p = Path(p)
            if p.is_dir():
                files += list(p.rglob("**/*.*"))
            elif p.is_file():
                with p.open() as t:
                    files += [
                        p.parent / x.lstrip(os.sep)
                        for x in t.read().strip().splitlines()
                    ]
            else:
                raise FileNotFoundError(f"{prefix}{p} does not exist")
        self.img_files = sorted(
            str(x) for x in files if x.suffix[1:].lower() in IMG_FORMATS
        )
        if not self.img_files:
            raise FileNotFoundError(f"{prefix}no images found in {path}")
        self.de_label_files, self.se_label_files = img2label_paths(self.img_files)

        # ---- label cache ----
        cache_path = Path(self.de_label_files[0]).parent.with_suffix(".cache.pkl")
        cache = None
        want_hash = get_hash(
            self.de_label_files + self.se_label_files + self.img_files
        )
        if cache_path.is_file():
            try:
                with open(cache_path, "rb") as f:
                    cache = pickle.load(f)
                if cache.get("hash") != want_hash or cache.get("version") != \
                        CACHE_VERSION:
                    cache = None
            except Exception:
                cache = None
        if cache is None:
            cache = self._build_cache(want_hash)
            try:
                cache_path.parent.mkdir(parents=True, exist_ok=True)
                with open(cache_path, "wb") as f:
                    pickle.dump(cache, f)
            except OSError as e:
                LOGGER.warning("%scache dir not writable: %s", prefix, e)

        items = cache["items"]  # list of (im_file, shape(w,h), det, seg)
        if augment and not items:
            raise ValueError(f"{prefix}no labels in {path}, cannot train")
        self.img_files = [it[0] for it in items]
        self.shapes = np.asarray([it[1] for it in items], np.float32)  # (w, h)
        self.det_labels = [it[2] for it in items]
        self.seg_labels = [it[3] for it in items]
        # collate ships seg masks as uint8 (4x less memcpy/transfer);
        # validate once that every class id actually fits — a stray
        # negative/ignore id or a >255-class dataset would otherwise wrap
        # silently into a valid-looking class
        bad = {int(c) for s in self.seg_labels for c, _ in s
               if not 0 <= int(c) <= 255}
        if bad:
            raise ValueError(
                f"{prefix}seg class ids out of uint8 range {sorted(bad)[:10]} "
                "(the pipeline ships masks as uint8; remap ignore/negative "
                "ids and keep se_nc <= 256)")
        self.de_label_files, self.se_label_files = img2label_paths(self.img_files)
        if single_cls:
            for d in self.det_labels:
                if len(d):
                    d[:, 0] = 0
            self.seg_labels = [[(0, p) for _, p in s] for s in self.seg_labels]
        self.n = len(self.img_files)
        self.indices = np.arange(self.n)

        if self.rect:
            self._setup_rect()

        # the decoded-image cache: decode and resize every image once
        self.im_cache: Optional[List] = None
        if cache_images:
            self._setup_image_cache(cache_images, prefix)

    # ------------------------------------------------------------------
    def _setup_image_cache(self, mode: str, prefix: str = ""):
        """Decode and resize every image once. 'ram' keeps the arrays
        (read-only); 'disk' writes .npy files into ``<labels>.imgcache``
        beside the label cache and reads them back memory-mapped, so the
        page cache shares them across threads and runs. The key holds the
        file's path, size and mtime and ``img_size``, as the JAX package's
        does, so either package reads the other's files."""
        from concurrent.futures import ThreadPoolExecutor

        self.im_cache = [None] * self.n
        cdir = None
        if mode == "disk":
            cdir = Path(self.de_label_files[0]).parent.with_suffix(".imgcache")
            cdir.mkdir(parents=True, exist_ok=True)

        def one(i):
            if mode == "ram":
                arr, hw0, hw = self.load_image(i)
                arr = np.ascontiguousarray(arr)
                arr.setflags(write=False)
                self.im_cache[i] = (arr, hw0, hw)
                return arr.nbytes
            p = Path(self.img_files[i])
            st = p.stat()
            key = hashlib.sha1(
                f"{p.resolve()}:{st.st_size}:{int(st.st_mtime)}:"
                f"{self.img_size}:rgb".encode()).hexdigest()[:24]
            f = cdir / f"{key}.npy"
            if not f.exists():
                arr, _, _ = self.load_image(i)
                tmp = f.with_suffix(f".{os.getpid()}.tmp.npy")
                np.save(tmp, np.ascontiguousarray(arr))
                os.replace(tmp, f)
                nbytes = arr.nbytes
            else:
                nbytes = f.stat().st_size
            self.im_cache[i] = f
            return nbytes

        with ThreadPoolExecutor(max_workers=NUM_THREADS) as ex:
            total = sum(ex.map(one, range(self.n)))
        LOGGER.info("%simage cache (%s): %d images, %.2f GB", prefix, mode,
                    self.n, total / 1e9)

    # ------------------------------------------------------------------
    def _build_cache(self, want_hash):
        items = []
        stats = dict(found=0, missing=0, empty=0, corrupt=0)
        msgs = []
        with ThreadPool(NUM_THREADS) as pool:
            results = pool.map(
                verify_image_label,
                zip(self.img_files, self.de_label_files, self.se_label_files),
            )
        for im_file, det, seg, shape, nm, nf, ne, nc, msg in results:
            stats["missing"] += nm
            stats["found"] += nf
            stats["empty"] += ne
            stats["corrupt"] += nc
            if msg:
                msgs.append(msg)
            if im_file is not None and (len(det) or len(seg)):
                items.append((im_file, shape, det, seg))
        for m in msgs:
            LOGGER.warning(m)
        LOGGER.info(
            "scanned %d images: %d det labels found, %d missing, %d empty, "
            "%d corrupt; %d usable",
            len(self.img_files), stats["found"], stats["missing"],
            stats["empty"], stats["corrupt"], len(items),
        )
        return {"hash": want_hash, "version": CACHE_VERSION, "items": items,
                "stats": stats}

    def _setup_rect(self):
        """Aspect-ratio-sorted per-batch shapes."""
        ar = self.shapes[:, 1] / self.shapes[:, 0]  # h / w
        order = ar.argsort()
        self.indices = order
        bi = np.floor(np.arange(self.n) / self.batch_size).astype(int)
        nb = bi[-1] + 1
        ar_sorted = ar[order]
        shapes = []
        for i in range(nb):
            ari = ar_sorted[bi == i]
            mini, maxi = ari.min(), ari.max()
            if maxi < 1:
                shapes.append([maxi, 1])
            elif mini > 1:
                shapes.append([1, 1 / mini])
            else:
                shapes.append([1, 1])
        self.batch_index = bi
        self.batch_shapes = (
            np.ceil(np.asarray(shapes) * self.img_size / self.stride + self.pad)
            .astype(int) * self.stride
        )

    # ------------------------------------------------------------------
    def __len__(self):
        return self.n

    def set_epoch(self, epoch: int):
        self.epoch = epoch

    def resample(self, image_weights: np.ndarray, rng: np.random.Generator):
        """Class-weighted image resampling for the next epoch."""
        w = np.asarray(image_weights, np.float64)
        w = w / w.sum()
        self.indices = rng.choice(self.n, size=self.n, p=w)

    def sample_rng(self, index: int) -> np.random.Generator:
        return np.random.default_rng(
            np.random.SeedSequence([self.seed, self.epoch, int(index)])
        )

    def load_image(self, index: int):
        """Decode + EXIF-correct + resize long side to img_size. Returns
        (RGB uint8 array, (h0, w0), (h, w)): from the image cache where
        there is one, else by the scaled JPEG decode with ``fast_decode``
        (PIL for the files it does not take), else by PIL."""
        from PIL import Image, ImageOps

        if self.im_cache is not None:
            c = self.im_cache[index]
            if isinstance(c, tuple):  # ram: (arr, (h0, w0), (h, w))
                return c
            if c is not None:  # disk: a memory-mapped, read-only .npy
                arr = np.load(c, mmap_mode="r")
                w0, h0 = self.shapes[index]  # the label cache keeps (w, h)
                return arr, (int(h0), int(w0)), arr.shape[:2]
        path = self.img_files[index]
        if self.fast_decode:
            out = self._load_image_fast(path)
            if out is not None:
                return out
        img = Image.open(path)
        try:  # exif_transpose copies the whole image even when there is no
            # orientation tag; only pay it when a rotation actually applies
            rotated = img.getexif().get(0x0112, 1) != 1
        except Exception:  # noqa: BLE001 - unreadable EXIF: take the safe path
            rotated = True
        if rotated:
            img = ImageOps.exif_transpose(img)
        w0, h0 = img.size
        r = self.img_size / max(w0, h0)
        if r != 1:  # LANCZOS for down- and up-scaling, as the JAX package
            img = img.resize((int(w0 * r), int(h0 * r)), Image.LANCZOS)
        arr = np.asarray(img.convert("RGB"))
        return arr, (h0, w0), arr.shape[:2]

    def _load_image_fast(self, path):
        """The scaled JPEG decode at the largest DCT scale whose long side
        stays >= ``img_size``, then one cv2 resize (INTER_AREA down,
        INTER_LINEAR up) to PIL's output size. None, so that PIL decodes the
        file, for a file that is not a JPEG, an EXIF-rotated one or a stream
        libjpeg refuses, as in the JAX package."""
        from PIL import Image

        from desenet_tpu_torch import native

        try:
            with open(path, "rb") as f:
                data = f.read()
        except OSError:
            return None
        if data[:2] != b"\xff\xd8":
            return None
        if b"Exif" in data[:256]:
            # an orientation tag needs PIL's transpose
            try:
                with Image.open(path) as im:
                    if im.getexif().get(0x0112, 1) != 1:
                        return None
            except Exception:  # noqa: BLE001 - unreadable EXIF: PIL's path
                return None
        out = native.decode_jpeg_scaled(data, self.img_size)
        if out is None:
            return None
        arr, (h0, w0) = out
        r = self.img_size / max(w0, h0)
        tw, th = int(w0 * r), int(h0 * r)
        if arr.shape[:2] != (th, tw):
            import cv2

            interp = (cv2.INTER_AREA if (th <= arr.shape[0]
                                         and tw <= arr.shape[1])
                      else cv2.INTER_LINEAR)
            arr = cv2.resize(arr, (tw, th), interpolation=interp)
        return arr, (h0, w0), arr.shape[:2]

    # ------------------------------------------------------------------
    def get_sample(self, pos: int):
        """The sample at dataset position `pos`, augmented when the dataset
        is: (img RGB uint8 HWC, det (n,5) [cls,xywhn], seg_mask (H,W) int32,
        path, shapes)."""
        index = int(self.indices[pos])
        rng = self.sample_rng(index)
        hyp = self.hyp

        if self.mosaic and rng.random() < hyp.get("mosaic", 0.0):
            if rng.random() < hyp.get("mosaic9", 0.0):
                img, det, seg = self._load_mosaic9(index, rng)
            else:
                img, det, seg = self._load_mosaic(index, rng)
            shapes = None
            do_persp = False  # the mosaic already took random_perspective
            if rng.random() < hyp.get("mixup", 0.0):
                img2, det2, seg2 = self._load_mosaic(
                    int(rng.integers(self.n)), rng)
                img, det, seg = mixup(img, det, seg, img2, det2, seg2, rng)
        else:
            img, (h0, w0), (h, w) = self.load_image(index)
            shape = (self.batch_shapes[self.batch_index[pos]] if self.rect
                     else self.img_size)
            img, ratio, pad = letterbox(img, shape, auto=False,
                                        scaleup=self.augment)
            shapes = (h0, w0), ((h / h0, w / w0), pad)
            det = self.det_labels[index].copy()
            seg = [(c, p.copy()) for c, p in self.seg_labels[index]]
            if len(det):
                det[:, 1:] = denorm_boxes(det[:, 1:], ratio[0] * w,
                                          ratio[1] * h, pad[0], pad[1])
            seg = denorm_polys(seg, ratio[0] * w, ratio[1] * h, pad[0], pad[1])
            do_persp = self.augment

        if do_persp:
            img, det, seg = random_perspective(img, det, seg, rng,
                                               **self._warp())
        if self.augment:
            img = np.ascontiguousarray(img)
            if not img.flags.writeable:  # a decoded image passed through
                img = img.copy()  # the letterbox untouched; HSV is in place
            augment_hsv(img, rng, hyp.get("hsv_h", 0), hyp.get("hsv_s", 0),
                        hyp.get("hsv_v", 0))

        # pixel xyxy -> normalized xywh
        if len(det):
            xyxy = det[:, 1:5]
            out = np.empty_like(xyxy)
            out[:, 0] = (xyxy[:, 0] + xyxy[:, 2]) / 2 / img.shape[1]
            out[:, 1] = (xyxy[:, 1] + xyxy[:, 3]) / 2 / img.shape[0]
            out[:, 2] = (xyxy[:, 2] - xyxy[:, 0]) / img.shape[1]
            out[:, 3] = (xyxy[:, 3] - xyxy[:, 1]) / img.shape[0]
            det[:, 1:5] = out

        if self.augment:
            if rng.random() < hyp.get("flipud", 0.0):
                img, det, seg = flip_ud(img, det, seg)
            if rng.random() < hyp.get("fliplr", 0.0):
                img, det, seg = flip_lr(img, det, seg)

        seg_mask = rasterize_polygons(seg, img.shape[:2])
        return (img, det.astype(np.float32), seg_mask, self.img_files[index],
                shapes)

    def _warp(self) -> dict:
        """random_perspective's arguments from the hyperparameters."""
        return {k: self.hyp.get(k, 0.0) for k in
                ("degrees", "translate", "scale", "shear", "perspective")}

    def _load_mosaic(self, index: int, rng: np.random.Generator):
        """4-image mosaic on a 2s x 2s canvas, then the perspective warp."""
        s = self.img_size
        yc = int(rng.uniform(-self.mosaic_border[0], 2 * s + self.mosaic_border[0]))
        xc = int(rng.uniform(-self.mosaic_border[1], 2 * s + self.mosaic_border[1]))
        idxs = [index] + list(rng.choice(self.n, 3))
        rng.shuffle(idxs)
        canvas = np.full((s * 2, s * 2, 3), PAD_VALUE, np.uint8)
        det4, seg4 = [], []
        for i, idx in enumerate(idxs):
            img, _, (h, w) = self.load_image(int(idx))
            if i == 0:  # top-left
                x1a, y1a, x2a, y2a = max(xc - w, 0), max(yc - h, 0), xc, yc
                x1b, y1b = w - (x2a - x1a), h - (y2a - y1a)
                x2b, y2b = w, h
            elif i == 1:  # top-right
                x1a, y1a, x2a, y2a = xc, max(yc - h, 0), min(xc + w, s * 2), yc
                x1b, y1b = 0, h - (y2a - y1a)
                x2b, y2b = min(w, x2a - x1a), h
            elif i == 2:  # bottom-left
                x1a, y1a, x2a, y2a = max(xc - w, 0), yc, xc, min(s * 2, yc + h)
                x1b, y1b = w - (x2a - x1a), 0
                x2b, y2b = w, min(y2a - y1a, h)
            else:  # bottom-right
                x1a, y1a = xc, yc
                x2a, y2a = min(xc + w, s * 2), min(s * 2, yc + h)
                x1b, y1b = 0, 0
                x2b, y2b = min(w, x2a - x1a), min(y2a - y1a, h)
            canvas[y1a:y2a, x1a:x2a] = img[y1b:y2b, x1b:x2b]
            padw, padh = x1a - x1b, y1a - y1b

            det = self.det_labels[int(idx)].copy()
            if len(det):
                det[:, 1:] = denorm_boxes(det[:, 1:], w, h, padw, padh)
            det4.append(det)
            seg4.append(denorm_polys(
                [(c, p.copy()) for c, p in self.seg_labels[int(idx)]],
                w, h, padw, padh,
            ))

        det4 = np.concatenate(det4, 0) if det4 else np.zeros((0, 5), np.float32)
        if len(det4):
            det4[:, 1:] = det4[:, 1:].clip(0, 2 * s)
        seg_all = [(c, p.clip(0, 2 * s)) for part in seg4 for c, p in part]
        return random_perspective(canvas, det4, seg_all, rng,
                                  border=self.mosaic_border, **self._warp())

    def _load_mosaic9(self, index: int, rng: np.random.Generator):
        """9-image 3x3 mosaic with seg polygons, then the perspective warp."""
        s = self.img_size
        idxs = [index] + list(rng.choice(self.n, 8))
        canvas = np.full((s * 3, s * 3, 3), PAD_VALUE, np.uint8)
        det9, seg9 = [], []
        hp = wp = h0 = w0 = -1
        for i, idx in enumerate(idxs):
            img, _, (h, w) = self.load_image(int(idx))
            if i == 0:
                h0, w0 = h, w
            c = _mosaic9_position(i, s, w, h, w0, h0, wp, hp)
            padw, padh = c[0], c[1]
            x1, y1, x2, y2 = (max(v, 0) for v in c)
            canvas[y1:y2, x1:x2] = img[y1 - padh:, x1 - padw:][
                : y2 - y1, : x2 - x1
            ]
            hp, wp = h, w

            det = self.det_labels[int(idx)].copy()
            if len(det):
                det[:, 1:] = denorm_boxes(det[:, 1:], w, h, padw, padh)
            det9.append(det)
            seg9.append(denorm_polys(
                [(cc, p.copy()) for cc, p in self.seg_labels[int(idx)]],
                w, h, padw, padh,
            ))

        yc = int(rng.uniform(0, s))
        xc = int(rng.uniform(0, s))
        canvas = canvas[yc:yc + 2 * s, xc:xc + 2 * s]
        det9 = np.concatenate(det9, 0) if det9 else np.zeros((0, 5), np.float32)
        if len(det9):
            det9[:, [1, 3]] -= xc
            det9[:, [2, 4]] -= yc
            det9[:, 1:] = det9[:, 1:].clip(0, 2 * s)
        seg_all = []
        for part in seg9:
            for cc, p in part:
                q = p - np.asarray([xc, yc], np.float32)
                seg_all.append((cc, q.clip(0, 2 * s)))
        return random_perspective(canvas, det9, seg_all, rng,
                                  border=self.mosaic_border, **self._warp())


def require_fast_decode() -> None:
    """Raise unless the native library decodes JPEG: the scaled decode's
    pixels differ from PIL's, so PIL does not stand in for it."""
    from desenet_tpu_torch import native

    if not native.jpeg_available():
        raise RuntimeError(
            "fast_decode needs the native library built with libjpeg "
            "(jpeglib.h was not found when it was built, or "
            "DESENET_NATIVE=0); PIL's pixels differ, so it does not stand in")


def _mosaic9_position(i, s, w, h, w0, h0, wp, hp):
    """Placement rectangle for the i-th tile of a 3x3 mosaic."""
    return [
        (s, s, s + w, s + h),
        (s, s - h, s + w, s),
        (s + wp, s - h, s + wp + w, s),
        (s + w0, s, s + w0 + w, s + h),
        (s + w0, s + hp, s + w0 + w, s + hp + h),
        (s + w0 - w, s + h0, s + w0, s + h0 + h),
        (s + w0 - wp - w, s + h0, s + w0 - wp, s + h0 + h),
        (s - w, s + h0 - h, s, s + h0),
        (s - w, s + h0 - hp - h, s, s + h0 - hp),
    ][i]


def collate_quad(samples, max_targets: int = 128, rng=None):
    """Quad collate: groups of 4 samples become either one 2x2 super-image
    (labels offset and scaled, seg masks tiled) or a 2x-upscaled single
    (seg by nearest). ``rng``: an epoch/batch-derived generator (the loader
    passes one); a fresh OS-seeded one when None."""
    if len(samples) < 4 or len(samples) % 4:
        raise ValueError(f"quad collate needs a multiple of 4 samples, "
                         f"got {len(samples)}")
    if rng is None:
        rng = np.random.default_rng()
    out_imgs, out_dets, out_segs, out_paths, out_shapes = [], [], [], [], []
    for g in range(len(samples) // 4):
        quad = samples[g * 4:(g + 1) * 4]
        imgs, dets, segs, paths, shapes = zip(*quad)
        h, w = imgs[0].shape[:2]
        if rng.random() < 0.5:  # 2x upscale of the first sample
            import cv2

            im = cv2.resize(imgs[0], (w * 2, h * 2),
                            interpolation=cv2.INTER_LINEAR)
            dl = dets[0].copy()
            sl = cv2.resize(segs[0].astype(np.uint8), (w * 2, h * 2),
                            interpolation=cv2.INTER_NEAREST)
        else:  # 2x2 tiling
            top = np.concatenate([imgs[0], imgs[1]], axis=1)
            bot = np.concatenate([imgs[2], imgs[3]], axis=1)
            im = np.concatenate([top, bot], axis=0)
            offs = [(0, 0), (0.5, 0), (0, 0.5), (0.5, 0.5)]  # (dx, dy)
            dls = []
            for d, (dx, dy) in zip(dets, offs):
                if not len(d):
                    continue
                d = d.copy()
                d[:, 1] = d[:, 1] * 0.5 + dx
                d[:, 2] = d[:, 2] * 0.5 + dy
                d[:, 3:5] *= 0.5
                dls.append(d)
            dl = np.concatenate(dls, 0) if dls else np.zeros((0, 5), np.float32)
            st = np.concatenate([segs[0], segs[1]], axis=1)
            sb = np.concatenate([segs[2], segs[3]], axis=1)
            sl = np.concatenate([st, sb], axis=0)
        out_imgs.append(im)
        out_dets.append(dl)
        out_segs.append(sl)
        out_paths.append(paths[0])
        out_shapes.append(shapes[0])
    det_t, det_m = pad_det_targets(out_dets, max_targets)
    return {
        "image": np.stack(out_imgs, 0),
        "det_targets": det_t,
        "det_mask": det_m,
        "seg_labels": np.stack(out_segs, 0).astype(np.uint8),
        "paths": out_paths,
        "shapes": out_shapes,
    }


def pad_det_targets(dets: Sequence[np.ndarray], max_targets: int):
    """List of per-image (n,5) [cls,xywhn] -> (B, M, 5) + (B, M) mask.
    Overflow beyond max_targets is dropped with a warning."""
    b = len(dets)
    out = np.zeros((b, max_targets, 5), np.float32)
    mask = np.zeros((b, max_targets), bool)
    for i, d in enumerate(dets):
        n = len(d)
        if n > max_targets:
            LOGGER.warning("image has %d targets, truncating to %d", n,
                           max_targets)
            d = d[:max_targets]
            n = max_targets
        out[i, :n] = d
        mask[i, :n] = True
    return out, mask


def collate(samples, max_targets: int = 128):
    """Samples -> fixed-shape batch dict for the train and eval steps; the
    images packed by ``native.assemble_batch``."""
    from desenet_tpu_torch.native import assemble_batch

    imgs, dets, segs, paths, shapes = zip(*samples)
    det_t, det_m = pad_det_targets(dets, max_targets)
    return {
        "image": assemble_batch(list(imgs)),
        "det_targets": det_t,
        "det_mask": det_m,
        # uint8: seg class ids are < 256 by construction; the narrow dtype
        # quarters the collate memcpy and the host->device batch transfer;
        # consumers widen on the device
        "seg_labels": np.stack(segs, 0).astype(np.uint8),
        "paths": list(paths),
        "shapes": list(shapes),
    }
