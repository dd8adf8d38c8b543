"""ctypes bridge to the port's native host library (``csrc/host/fastops.cpp``).

The port's own copy of ``desenet_tpu/native.py``, with its names:
``available``, ``assemble_batch``, ``assemble_batch_s2d4``,
``rasterize_polygons_native``, ``jpeg_available`` and
``decode_jpeg_scaled``. The library is built at
first use (never at import) by the host compiler, with the flags of the
JAX package's ``native/Makefile`` less ``-march=native`` (the build
directory is keyed by the source's hash and may outlive the machine):
``-O3 -fPIC -std=c++17 -ffp-contract=off``, ``-fopenmp`` where the
compiler has OpenMP (without it the batch loops run on the calling
thread; the loader's threads still run batches side by side), and
``-DDESENET_HAVE_JPEG -ljpeg`` where ``jpeglib.h`` preprocesses. It goes
into the git-ignored ``_build/host-<hash>/`` (the hash of the source, the
compiler's version and the flags), through a temporary file and
``os.replace``, under an ``fcntl`` lock, so that processes building at the
same time leave one loadable library.

A failed build raises with the compiler's output; nothing falls back
quietly. ``DESENET_NATIVE=0`` is the caller asking for the Python paths
(``np.stack``, PIL): then ``available()`` is False and the wrappers take
them, as the JAX package's do.
"""

from __future__ import annotations

import ctypes
import fcntl
import hashlib
import os
import shutil
import struct
import subprocess
import threading
from typing import Optional, Sequence, Tuple

import numpy as np

_PKG = os.path.dirname(os.path.abspath(__file__))
SOURCE = os.path.join(_PKG, "csrc", "host", "fastops.cpp")
BUILD_ROOT = os.path.join(_PKG, "_build")
LIB_NAME = "libfastops.so"
VERSION = 4
CXX_FLAGS = ("-O3", "-fPIC", "-std=c++17", "-ffp-contract=off", "-Wall",
             "-shared")
OPENMP_FLAGS = ("-fopenmp",)
JPEG_FLAGS = ("-DDESENET_HAVE_JPEG",)
JPEG_LIBS = ("-ljpeg",)

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None


def _cxx() -> str:
    cxx = os.environ.get("CXX") or shutil.which("g++") or shutil.which("c++")
    if not cxx:
        raise RuntimeError("no C++ compiler (g++, c++ or $CXX) to build "
                           f"{SOURCE}")
    return cxx


def has_jpeg_header(cxx: str) -> bool:
    """Whether ``#include <jpeglib.h>`` preprocesses (the Makefile's test)."""
    proc = subprocess.run([cxx, "-E", "-x", "c++", "-"],
                          input="#include <jpeglib.h>\n", capture_output=True,
                          text=True)
    return proc.returncode == 0


def has_openmp(cxx: str) -> bool:
    """Whether ``-fopenmp`` compiles and links a shared library (a compiler
    may ship without libgomp)."""
    proc = subprocess.run([cxx, *OPENMP_FLAGS, "-shared", "-fPIC", "-x",
                           "c++", "-", "-o", os.devnull],
                          input="int f() { return 0; }\n",
                          capture_output=True, text=True)
    return proc.returncode == 0


def build_flags(cxx: str) -> Tuple[Tuple[str, ...], Tuple[str, ...]]:
    """(compile flags, libraries) for this machine's compiler."""
    flags = CXX_FLAGS + (OPENMP_FLAGS if has_openmp(cxx) else ())
    if has_jpeg_header(cxx):
        return flags + JPEG_FLAGS, JPEG_LIBS
    return flags, ()


def build_dir(cxx: str, flags: Sequence[str]) -> str:
    """The build directory for the current source, the compiler (its
    version line) and ``flags``."""
    version = subprocess.run([cxx, "--version"], capture_output=True,
                             text=True).stdout.split("\n")[0]
    h = hashlib.sha256(" ".join([version, *flags]).encode())
    with open(SOURCE, "rb") as fh:
        h.update(fh.read())
    return os.path.join(BUILD_ROOT, "host-" + h.hexdigest()[:16])


def build() -> str:
    """Build the library if it is not built yet; returns its path. One
    process builds while the others wait on the directory's lock."""
    cxx = _cxx()
    flags, libs = build_flags(cxx)
    out_dir = build_dir(cxx, flags)
    so = os.path.join(out_dir, LIB_NAME)
    os.makedirs(out_dir, exist_ok=True)
    with open(os.path.join(out_dir, "lock"), "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        if os.path.exists(so):
            return so
        tmp = os.path.join(out_dir, f"{LIB_NAME}.{os.getpid()}.tmp")
        cmd = [cxx, *flags, "-o", tmp, SOURCE, *libs]
        proc = subprocess.run(cmd, capture_output=True, text=True)
        with open(os.path.join(out_dir, "build.log"), "w") as fh:
            fh.write(" ".join(cmd) + "\n" + proc.stdout + proc.stderr)
        if proc.returncode != 0:
            if os.path.exists(tmp):
                os.remove(tmp)
            raise RuntimeError(f"building {SOURCE} failed "
                               f"({proc.returncode}): {' '.join(cmd)}\n"
                               f"{proc.stdout}{proc.stderr}")
        os.replace(tmp, so)
    return so


def _load() -> Optional[ctypes.CDLL]:
    """The library, built and loaded once a process; None when the caller
    asked for the Python paths (``DESENET_NATIVE=0``)."""
    global _lib
    if os.environ.get("DESENET_NATIVE", "1") == "0":
        return None
    with _lock:
        if _lib is None:
            lib = ctypes.CDLL(build())
            _P, _I64 = ctypes.c_void_p, ctypes.c_int64
            _PI32 = ctypes.POINTER(ctypes.c_int32)
            lib.assemble_batch.argtypes = [_P, ctypes.POINTER(_P), _I64, _I64]
            lib.assemble_batch.restype = None
            lib.assemble_batch_s2d4.argtypes = [_P, ctypes.POINTER(_P)] + \
                [_I64] * 4
            lib.assemble_batch_s2d4.restype = None
            lib.rasterize_polygons.argtypes = [_P, _I64, _I64, _P, _P, _P,
                                               _I64]
            lib.rasterize_polygons.restype = _I64
            lib.decode_jpeg_scaled.argtypes = [_P, _I64, ctypes.c_int32, _P,
                                               _I64] + [_PI32] * 4
            lib.decode_jpeg_scaled.restype = ctypes.c_int
            lib.has_jpeg.argtypes = []
            lib.has_jpeg.restype = ctypes.c_int
            lib.fastops_version.argtypes = []
            lib.fastops_version.restype = ctypes.c_int
            if lib.fastops_version() != VERSION:
                raise RuntimeError(f"{LIB_NAME}: version "
                                   f"{lib.fastops_version()}, want {VERSION}")
            _lib = lib
        return _lib


def available() -> bool:
    return _load() is not None


def _pointers(arrays: Sequence[np.ndarray]):
    return (ctypes.c_void_p * len(arrays))(
        *[a.ctypes.data_as(ctypes.c_void_p).value for a in arrays])


def assemble_batch(samples: Sequence[np.ndarray]) -> np.ndarray:
    """Pack N same-shape uint8 arrays into one (N, ...) batch with one
    parallel memcpy that holds no Python lock; ``np.stack`` when the
    library is opted out."""
    lib = _load()
    if lib is None or not samples:
        return np.stack(samples, 0)
    shape = samples[0].shape
    if any(s.shape != shape for s in samples):
        raise ValueError("assemble_batch: samples differ in shape: "
                         f"{sorted({s.shape for s in samples})}")
    srcs = [np.ascontiguousarray(s, dtype=np.uint8) for s in samples]
    out = np.empty((len(srcs), *shape), np.uint8)
    lib.assemble_batch(out.ctypes.data_as(ctypes.c_void_p), _pointers(srcs),
                       len(srcs), int(np.prod(shape)))
    return out


def assemble_batch_s2d4(samples: Sequence[np.ndarray]) -> np.ndarray:
    """Pack N (H, W, C) uint8 samples into one (N, H/4, W/4, 16C) batch in
    space-to-depth-4 layout (the phase stem's input, ``ops/s2d.py``), the
    permutation folded into the batch copy; ``ops.s2d.space_to_depth4_np``
    of ``np.stack`` when the library is opted out. H or W not divisible by
    4 raises ValueError."""
    h, w, c = samples[0].shape
    if h % 4 or w % 4:
        raise ValueError(f"s2d4 needs H, W divisible by 4, got {h}x{w}")
    lib = _load()
    if lib is None:
        from desenet_tpu_torch.ops.s2d import space_to_depth4_np

        return space_to_depth4_np(np.stack(samples, 0))
    if any(s.shape != (h, w, c) for s in samples):
        raise ValueError("assemble_batch_s2d4: samples differ in shape: "
                         f"{sorted({s.shape for s in samples})}")
    srcs = [np.ascontiguousarray(s, dtype=np.uint8) for s in samples]
    out = np.empty((len(srcs), h // 4, w // 4, 16 * c), np.uint8)
    lib.assemble_batch_s2d4(out.ctypes.data_as(ctypes.c_void_p),
                            _pointers(srcs), len(srcs), h, w, c)
    return out


def rasterize_polygons_native(
    seg: Sequence[Tuple[int, np.ndarray]], hw: Tuple[int, int]
) -> Optional[np.ndarray]:
    """PIL-exact class-id mask of ``seg`` ((cls_id, (k, 2) pixel polygon)
    pairs; later polygons overwrite earlier ones, fewer than 3 points are
    ignored), (H, W) int32. None when the library is opted out or a polygon
    is degenerate (self-intersecting or a repeated vertex): the caller then
    draws the whole mask with PIL, so the result equals PIL's either way."""
    lib = _load()
    if lib is None:
        return None
    mask = np.zeros(hw, np.int32)
    polys = [(int(c), p) for c, p in seg if len(p) > 2]
    if not polys:
        return mask
    flat = np.ascontiguousarray(
        np.concatenate([p.astype(np.float32) for _, p in polys], 0))
    counts = np.asarray([len(p) for _, p in polys], np.int64)
    cls = np.asarray([c for c, _ in polys], np.int32)
    done = lib.rasterize_polygons(
        mask.ctypes.data_as(ctypes.c_void_p), hw[0], hw[1],
        flat.ctypes.data_as(ctypes.c_void_p),
        counts.ctypes.data_as(ctypes.c_void_p),
        cls.ctypes.data_as(ctypes.c_void_p), len(polys))
    return mask if done == len(polys) else None


def jpeg_available() -> bool:
    """Whether the built library decodes JPEG (libjpeg found at build)."""
    lib = _load()
    return lib is not None and bool(lib.has_jpeg())


def jpeg_size(data: bytes) -> Optional[Tuple[int, int]]:
    """(h, w) from a JPEG stream's SOF marker, or None."""
    i, n = 2, len(data)
    while i + 9 < n:
        if data[i] != 0xFF:
            i += 1
            continue
        marker = data[i + 1]
        if marker in (0xD8, 0x01) or 0xD0 <= marker <= 0xD7:
            i += 2
            continue
        seg_len = struct.unpack(">H", data[i + 2:i + 4])[0]
        if 0xC0 <= marker <= 0xCF and marker not in (0xC4, 0xC8, 0xCC):
            h, w = struct.unpack(">HH", data[i + 5:i + 9])
            return (h, w) if h and w else None
        i += 2 + seg_len
    return None


def decode_jpeg_scaled(
    data: bytes, target_long: int
) -> Optional[Tuple[np.ndarray, Tuple[int, int]]]:
    """RGB uint8 HWC decoded at the largest libjpeg M/8 scale whose long
    side stays >= ``target_long``, and the full-resolution (h0, w0). None
    for a stream that is not a clean JPEG (the caller decodes it with PIL,
    as the JAX package's does). Raises when the library was built without
    libjpeg or is opted out: those pixels would differ from this path's."""
    lib = _load()
    if lib is None or not lib.has_jpeg():
        raise RuntimeError(
            "decode_jpeg_scaled: the native library "
            + ("is opted out (DESENET_NATIVE=0)" if lib is None else
               "was built without libjpeg (no jpeglib.h at build time)"))
    if len(data) < 3 or data[:2] != b"\xff\xd8":
        return None
    hw = jpeg_size(data)
    if hw is None:
        return None
    buf = np.frombuffer(data, np.uint8)
    out = np.empty(hw[0] * hw[1] * 3, np.uint8)
    w, h, fw, fh = (ctypes.c_int32() for _ in range(4))
    ok = lib.decode_jpeg_scaled(
        buf.ctypes.data_as(ctypes.c_void_p), len(data), int(target_long),
        out.ctypes.data_as(ctypes.c_void_p), out.size, ctypes.byref(w),
        ctypes.byref(h), ctypes.byref(fw), ctypes.byref(fh))
    if not ok:
        return None
    return (out[: h.value * w.value * 3].reshape(h.value, w.value, 3),
            (fh.value, fw.value))
