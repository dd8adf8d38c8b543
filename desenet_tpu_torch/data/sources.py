"""Inference input sources: files, directories and globs of images and
videos, and webcam / RTSP / HTTP streams read by one thread each.

The port's copy of ``desenet_tpu/data/sources.py``, on the port's own
``letterbox``. numpy and the standard library at module level; cv2 is
imported where an image or a video is read.
"""

from __future__ import annotations

import glob
import os
import time
from pathlib import Path
from threading import Thread
from typing import List

import numpy as np

from desenet_tpu_torch.data.augment import letterbox

IMG_FORMATS = ["bmp", "jpg", "jpeg", "png", "tif", "tiff", "dng", "webp", "mpo"]
VID_FORMATS = ["mov", "avi", "mp4", "mpg", "mpeg", "m4v", "wmv", "mkv"]


class LoadImages:
    """Iterate over image and video files: yields (path, letterboxed RGB
    uint8 HWC image, native BGR image, the video capture or None)."""

    def __init__(self, path, img_size=640, stride=32, auto=False):
        p = str(Path(path).resolve())
        if "*" in p:
            files = sorted(glob.glob(p, recursive=True))
        elif os.path.isdir(p):
            files = sorted(glob.glob(os.path.join(p, "*.*")))
        elif os.path.isfile(p):
            files = [p]
        else:
            raise FileNotFoundError(f"{p} does not exist")

        images = [x for x in files if x.split(".")[-1].lower() in IMG_FORMATS]
        videos = [x for x in files if x.split(".")[-1].lower() in VID_FORMATS]
        self.img_size = img_size
        self.stride = stride
        self.auto = auto
        self.files = images + videos
        self.video_flag = [False] * len(images) + [True] * len(videos)
        self.nf = len(self.files)
        self.mode = "image"
        self.cap = None
        if not self.nf:
            raise FileNotFoundError(
                f"no images or videos found in {p} (images: {IMG_FORMATS}, "
                f"videos: {VID_FORMATS})")
        if videos:
            self._new_video(videos[0])

    def _new_video(self, path):
        import cv2

        self.frame = 0
        self.cap = cv2.VideoCapture(path)
        self.frames = int(self.cap.get(cv2.CAP_PROP_FRAME_COUNT))

    def __iter__(self):
        self.count = 0
        return self

    def __next__(self):
        import cv2

        if self.count == self.nf:
            raise StopIteration
        path = self.files[self.count]
        if self.video_flag[self.count]:
            self.mode = "video"
            ok, im0 = self.cap.read()
            if not ok:
                self.count += 1
                self.cap.release()
                if self.count == self.nf:
                    raise StopIteration
                self._new_video(self.files[self.count])
                path = self.files[self.count]
                ok, im0 = self.cap.read()
            self.frame += 1
        else:
            self.count += 1
            im0 = cv2.imread(path)
            if im0 is None:
                raise FileNotFoundError(f"image not found or unreadable: "
                                        f"{path}")
        img = letterbox(im0, self.img_size, stride=self.stride,
                        auto=self.auto)[0]
        img = np.ascontiguousarray(img[:, :, ::-1])  # BGR -> RGB, HWC
        return path, img, im0, self.cap

    def __len__(self):
        return self.nf


class LoadStreams:
    """Multi-stream reader, one thread a stream: a webcam index, an RTSP or
    HTTP url or a video file, or a ``.txt`` file of such sources, one a
    line. Yields (sources, (N, H, W, 3) letterboxed RGB uint8 batch, the
    native BGR frames, None)."""

    def __init__(self, sources="0", img_size=640, stride=32, auto=False):
        import cv2

        self.mode = "stream"
        self.img_size = img_size
        self.stride = stride
        self.auto = auto
        if os.path.isfile(sources) and sources.lower().endswith(".txt"):
            with open(sources) as f:
                sources = [x.strip() for x in f if x.strip()]
        else:
            sources = [sources]
        n = len(sources)
        self.sources = sources
        self.imgs: List = [None] * n
        self.fps = [0.0] * n
        self.frames = [0] * n
        self.threads: List[Thread] = [None] * n
        for i, s in enumerate(sources):
            cap = cv2.VideoCapture(int(s) if s.isnumeric() else s)
            if not cap.isOpened():
                raise OSError(f"failed to open {s}")
            w = int(cap.get(cv2.CAP_PROP_FRAME_WIDTH))
            h = int(cap.get(cv2.CAP_PROP_FRAME_HEIGHT))
            self.fps[i] = max(cap.get(cv2.CAP_PROP_FPS) % 100, 0) or 30.0
            self.frames[i] = (max(int(cap.get(cv2.CAP_PROP_FRAME_COUNT)), 0)
                              or float("inf"))
            ok, self.imgs[i] = cap.read()
            if not ok:
                raise OSError(f"failed to read from {s}")
            self.threads[i] = Thread(target=self._update, args=(i, cap, s),
                                     daemon=True)
            print(f"stream {i}: {s} ({w}x{h} at {self.fps[i]:.0f} FPS)")
            self.threads[i].start()

    def _update(self, i, cap, stream):
        n, f = 0, self.frames[i]
        while cap.isOpened() and n < f:
            n += 1
            cap.grab()
            ok, im = cap.retrieve()
            if ok:
                self.imgs[i] = im
            else:
                self.imgs[i] = np.zeros_like(self.imgs[i])
                cap.open(stream)  # re-open if the signal is lost
            time.sleep(1 / self.fps[i])

    def __iter__(self):
        self.count = -1
        return self

    def __next__(self):
        import cv2

        self.count += 1
        if not all(t.is_alive() for t in self.threads) or \
                cv2.waitKey(1) == ord("q"):
            cv2.destroyAllWindows()
            raise StopIteration
        im0 = [im.copy() for im in self.imgs]
        imgs = [np.ascontiguousarray(
            letterbox(im, self.img_size, stride=self.stride,
                      auto=self.auto)[0][:, :, ::-1]) for im in im0]
        return self.sources, np.stack(imgs), im0, None

    def __len__(self):
        return len(self.sources)
