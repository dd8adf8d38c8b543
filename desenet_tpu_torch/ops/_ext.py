"""Build and load the port's CUDA kernels.

Every ``csrc/*.cu`` file is compiled by ``nvcc`` for ``sm_90a`` into one
shared library with a plain C interface, loaded with ``ctypes``. The build
runs at first use (never at import: this module imports on machines without
``nvcc``) into ``desenet_tpu_torch/_build/<hash>/``, keyed by a hash of the
sources and flags, so an edited source rebuilds and an unchanged one loads.

Each C entry point launches on the stream it is given and returns
``cudaGetLastError()``; ``check`` turns a non-zero code into an exception.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading

import torch

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC = os.path.join(_PKG, "csrc")
BUILD_ROOT = os.path.join(_PKG, "_build")
LIB_NAME = "libdesenet_kernels.so"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_P = ctypes.c_void_p
_I = ctypes.c_int
_SIGNATURES = {
    # x1, y1, x2, y2, score, cls, B, A, max_det, iou_thres, scratch, out,
    # paths, index, stream, device
    "desenet_nms_fused": [_P] * 6 + [_I, _I, _I, ctypes.c_float, _P, _P, _P,
                                     _P, _P, _I],
    # x, is_bf16, ys, wy, xs, wx, seg, B, h, w, C, H, W, variant, G, rpt,
    # out, stream, device
    "desenet_seg_tail": [_P, _I] + [_P] * 5 + [_I] * 9 + [_P, _P, _I],
    # boxes, scores, B, K, max_det, iou_thres, scratch, keep_idx, keep_sc,
    # paths, stream, device
    "desenet_nms_greedy": [_P, _P, _I, _I, _I, ctypes.c_float, _P, _P, _P,
                           _P, _P, _I],
    # K4 (seg_head_psp2.cu). in1, ld1, c1, in2, ld2, c2, w, bias, rowbias,
    # add, add_ld, out, out_ld, B, H, W, taps, dil, O, mode, variant,
    # is_bf16, stream, device
    "desenet_psp2_conv": [_P, _I, _I, _P, _I, _I, _P, _P, _P, _P, _I, _P]
                         + [_I] * 10 + [_P, _I],
    # in, ld, C, P, weights, KK, B, out, is_bf16, stream, device
    "desenet_psp2_reduce": [_P, _I, _I, _I, _P, _I, _I, _P, _I, _P, _I],
    # in, N, Cin, w, bias, Cout, mode, is_bf16, out, stream, device
    "desenet_psp2_small": [_P, _I, _I, _P, _P, _I, _I, _I, _P, _P, _I],
    # up, ck, C, P, KK, B, out, ld_out, is_bf16, stream, device
    "desenet_psp2_unpool": [_P, _P, _I, _I, _I, _I, _P, _I, _I, _P, _I],
    # feat, gate, C, P, B, is_bf16, stream, device
    "desenet_psp2_gate": [_P, _P, _I, _I, _I, _I, _P, _I],
    # K5 (stem_conv.cu). x, wm, bias, B, H, W, CO, silu_on, is_bf16, variant,
    # out, stream, device
    "desenet_stem_conv": [_P] * 3 + [_I] * 7 + [_P, _P, _I],
    # the served stem (stem_conv.cu). x, wm, scale, shift, B, H, W, CO,
    # silu_on, vec, out, stream, device
    "desenet_stem_u8": [_P] * 4 + [_I] * 6 + [_P, _P, _I],
    # which parts of K5's tensor-core kernel run (-DK5_PROF builds). skip
    "desenet_stem_prof": [_I],
    # K6 (c3_fused.cu). x, w12, b12, wb1, bb1, wb2, bb2, w3, b3, B, H, W, C,
    # c_, C2, n, shortcut, th, tw, variant, is_bf16, out, stream, device
    "desenet_c3_fused": [_P] * 9 + [_I] * 12 + [_P, _P, _I],
    # K6's phase counters (zero unless built with -DK6_PROF). out, reset
    "desenet_c3_prof": [_P, _I],
    # int8_conv.cu. &Int8ConvArgs (ops/int8_conv.py:_Args), stream, device
    "desenet_int8_conv": [_P, _P, _I],
    # conv_epilogue.cu. y, res, scale, shift, P, C, act, is_bf16, vec,
    # stream, device
    "desenet_conv_epilogue": [_P] * 4 + [_I] * 5 + [_P, _I],
    # conv_epilogue.cu, the phase store. y, out, scale, shift, B, H, W, C,
    # is_bf16, vec, stream, device
    "desenet_conv_epilogue_phases": [_P] * 4 + [_I] * 6 + [_P, _I],
    # mask_assembly.cu. decode, A, ncol, coff, index, boxes, num, proto,
    # is_bf16, B, Hp, Wp, max_det, sx, sy, out, stream, device
    "desenet_mask_assembly": [_P, _I, _I, _I, _P, _P, _P, _P, _I, _I, _I,
                              _I, _I, ctypes.c_float, ctypes.c_float, _P,
                              _P, _I],
    # mma_peak.cu. blocks, threads, iters, sink, stream, device
    "desenet_mma_peak": [_I, _I, _I, _P, _P, _I],
    # mma_peak.cu. blocks, threads, iters, op, sink, stream, device
    "desenet_sfu_peak": [_I, _I, _I, _I, _P, _P, _I],
}

_lock = threading.Lock()
_lib = None


def _sources():
    return sorted(os.path.join(CSRC, f) for f in os.listdir(CSRC)
                  if f.endswith((".cu", ".cuh")))


def build_dir() -> str:
    """The build directory for the current sources and flags."""
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for path in _sources():
        h.update(os.path.basename(path).encode())
        with open(path, "rb") as fh:
            h.update(fh.read())
    return os.path.join(BUILD_ROOT, h.hexdigest()[:16])


def _nvcc() -> str:
    for cand in (shutil.which("nvcc"),
                 os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"),
                              "bin", "nvcc")):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found (PATH, $CUDA_HOME/bin or "
                       "/usr/local/cuda/bin): the CUDA kernels of "
                       "desenet_tpu_torch cannot be built")


def _build(out_dir: str) -> None:
    """One nvcc per source, all started together, then one link."""
    os.makedirs(out_dir, exist_ok=True)
    nvcc = _nvcc()
    tag = f"{os.getpid()}.tmp"
    compile_flags = [f for f in NVCC_FLAGS if f != "-shared"]
    jobs = []
    for src in (s for s in _sources() if s.endswith(".cu")):
        obj = os.path.join(out_dir, f"{os.path.basename(src)}.{tag}.o")
        cmd = [nvcc, *compile_flags, "-c", "-o", obj, src]
        jobs.append((cmd, obj, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True)))
    tmp = os.path.join(out_dir, f"{LIB_NAME}.{tag}")
    link = [nvcc, *NVCC_FLAGS, "-o", tmp, *[obj for _, obj, _ in jobs]]
    log, failed = [], []
    for cmd, _, proc in jobs:
        out = proc.communicate()[0]
        log.append(" ".join(cmd) + "\n" + out)
        if proc.returncode != 0:
            failed.append(f"{cmd[-1]} ({proc.returncode}):\n{out}")
    if not failed:
        proc = subprocess.run(link, capture_output=True, text=True)
        log.append(" ".join(link) + "\n" + proc.stdout + proc.stderr)
        if proc.returncode != 0:
            failed.append(f"link ({proc.returncode}):\n"
                          f"{proc.stdout}{proc.stderr}")
    for _, obj, _ in jobs:
        if os.path.exists(obj):
            os.remove(obj)
    with open(os.path.join(out_dir, "build.log"), "w") as fh:
        fh.write("\n".join(log))
    if failed:
        raise RuntimeError("nvcc failed: " + "\n".join(failed))
    os.replace(tmp, os.path.join(out_dir, LIB_NAME))


def load() -> ctypes.CDLL:
    """Build (if needed) and load the kernel library; cached per process."""
    global _lib
    with _lock:
        if _lib is None:
            d = build_dir()
            so = os.path.join(d, LIB_NAME)
            if not os.path.exists(so):
                _build(d)
            lib = ctypes.CDLL(so)
            for name, argtypes in _SIGNATURES.items():
                fn = getattr(lib, name)
                fn.argtypes = argtypes
                fn.restype = ctypes.c_int
            lib.desenet_cuda_error_string.argtypes = [ctypes.c_int]
            lib.desenet_cuda_error_string.restype = ctypes.c_char_p
            _lib = lib
        return _lib


def check(code: int, what: str) -> None:
    """Raise if a kernel entry point returned a CUDA error."""
    if code != 0:
        msg = load().desenet_cuda_error_string(code).decode()
        raise RuntimeError(f"{what}: CUDA error {code} ({msg})")


def stream_and_device(t):
    """ctypes arguments for launching on ``t``'s device and PyTorch's
    current stream there."""
    dev = t.device.index if t.device.index is not None else \
        torch.cuda.current_device()
    return torch.cuda.current_stream(dev).cuda_stream, dev
