"""Timing on the card and the profiler's kernel table, shared by the
probes, the profilers and ``chip_smoke.py``."""

from __future__ import annotations

import subprocess

import torch
from torch.autograd import DeviceType
from torch.profiler import ProfilerActivity, profile


def card_line() -> str:
    """The card's name and power limit as nvidia-smi prints them."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def cuda_ms(fn, reps: int) -> float:
    """Mean milliseconds of ``fn()`` over ``reps`` back-to-back runs, timed
    with CUDA events after one untimed run."""
    fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def in_turns(*runs) -> list:
    """Time ``(fn, reps)`` runs in order and then in reverse order (A B C C
    B A); return each one's mean of its two means, in ms."""
    first = [cuda_ms(fn, reps) for fn, reps in runs]
    second = [cuda_ms(fn, reps) for fn, reps in reversed(runs)][::-1]
    return [(a + b) / 2 for a, b in zip(first, second)]


RUNS = 5  # profiled calls
TOP = 30  # table rows printed
# the port's kernels, always printed
OWN = ("nms_fused_kernel", "seg_tail_", "mask_assembly_kernel")


def kernel_table(fn, device: torch.device):
    """[(name, ms per run, calls per run)] of the kernels (the host ops on
    the CPU) that ``RUNS`` calls of ``fn`` launch, most time first."""
    cuda = device.type == "cuda"
    sync = torch.cuda.synchronize if cuda else (lambda: None)
    fn()
    sync()
    acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if cuda else [])
    with profile(activities=acts) as prof:
        for _ in range(RUNS):
            fn()
        sync()
    want = DeviceType.CUDA if cuda else DeviceType.CPU
    rows = [(e.key, (e.self_device_time_total if cuda
                     else e.self_cpu_time_total) / 1e3 / RUNS, e.count / RUNS)
            for e in prof.key_averages() if e.device_type == want]
    return sorted(rows, key=lambda r: -r[1])


def show(title: str, rows, tail: str) -> float:
    total = sum(ms for _, ms, _ in rows)
    print(f"{title}: {total:.3f} ms per run in {len(rows)} kernels "
          f"{tail}", flush=True)
    for i, (name, ms, calls) in enumerate(rows):
        if i < TOP or any(own in name for own in OWN):
            print(f"  {ms:9.3f} ms {calls:7.1f} calls  {name[:110]}",
                  flush=True)
    return total


# ---- bounds: the least time the card could take for a kernel's work -------
#
# The larger of the bytes the function must move (each input read once, each
# output written once) over the card's memory rate and the operations it
# does on these inputs over the card's peak rate for their type. The rates
# are NVIDIA's published ones for the H100 SXM at its full power limit.
# Pure Python, from shapes: the CPU tests hold these against figures worked
# out by hand.

H100_BYTES_PER_S = 3.35e12       # HBM3
H100_BF16_FLOPS = 989e12         # dense bf16 on the tensor cores
H100_INT8_OPS = 1979e12          # dense int8 on the tensor cores
H100_F32_FLOPS = 67e12           # float32 outside the tensor cores
NMS_PAIR_FLOPS = 16              # one IoU test of a pick against a candidate


def bound_ms(flops: float, nbytes: float,
             peak_flops: float = H100_BF16_FLOPS) -> tuple:
    """(milliseconds, "bytes" or "operations"): the larger of
    ``nbytes`` over the memory rate and ``flops`` over ``peak_flops``."""
    t_bytes = nbytes / H100_BYTES_PER_S * 1e3
    t_ops = flops / peak_flops * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def c3_macs(b: int, h: int, w: int, c: int, c_: int, c2: int, n: int) -> int:
    """Multiply-adds of a C3 block: cv12, n bottlenecks (1x1 and 3x3), cv3."""
    return b * h * w * (2 * c * c_ + n * 10 * c_ * c_ + 2 * c_ * c2)


def c3_bound(b: int, h: int, w: int, c: int, c_: int, c2: int, n: int,
             itemsize: int = 2) -> tuple:
    """K6 on (b, h, w, c) -> c2: x, the weights (in ``itemsize``) and the
    f32 biases read once, the output written once; products at the bf16
    tensor-core rate."""
    weights = 2 * c * c_ + n * 10 * c_ * c_ + 2 * c_ * c2
    biases = 2 * c_ + 2 * n * c_ + c2
    nbytes = (b * h * w * (c + c2) + weights) * itemsize + 4 * biases
    return bound_ms(2 * c3_macs(b, h, w, c, c_, c2, n), nbytes)


def psp2_macs(h8: int, w8: int, chans, c_hid: int, n_segcls: int) -> int:
    """Multiply-adds per image of the fused SegMaskPSP2 head as
    ``fused_psp2_eval`` computes it (the m16/m32 stems at their own
    resolution with their 1x1 slices applied before the upsample), from the
    folded weights' shapes."""
    p8, p16, p32 = h8 * w8, (h8 // 2) * (w8 // 2), (h8 // 4) * (w8 // 4)
    inner = 3 * c_hid // 6          # ACSP's hidden width
    n_red = c_hid // 6              # context_red's output
    n4 = n_red // 4                 # one pyramid branch
    nctx = 4 * n4
    stems = (p8 * chans[0] + p16 * chans[1] + p32 * chans[2]) * c_hid
    slices = (p16 + p32) * c_hid * (inner + n_red)
    upsample = 2 * 4 * p8 * (inner + n_red)   # two planes, four taps
    acsp = p8 * (c_hid * inner + 3 * 9 * inner * inner + 3 * inner * c_hid) \
        + inner * inner + inner * c_hid       # the global branch
    pools = sum(k * k for k in (2, 3, 6))
    context = p8 * c_hid * n_red + pools * p8 * n_red \
        + (1 + pools) * n_red * n4 + pools * p8 * n4
    ffm = p8 * 9 * (c_hid + nctx) * c_hid + 2 * c_hid * c_hid
    return stems + slices + upsample + acsp + context + ffm \
        + p8 * c_hid * n_segcls


def psp2_bound(b: int, h8: int, w8: int, chans, c_hid: int, n_segcls: int,
               itemsize: int = 2) -> tuple:
    """K4 on [l16, l19, l22] -> (b, h8, w8, n_segcls) f32 logits: the three
    maps read once, the logits written once (the folded weights, under 1 MB,
    are left out)."""
    p8, p16, p32 = h8 * w8, (h8 // 2) * (w8 // 2), (h8 // 4) * (w8 // 4)
    nbytes = b * ((p8 * chans[0] + p16 * chans[1] + p32 * chans[2]) * itemsize
                  + p8 * n_segcls * 4)
    return bound_ms(2 * b * psp2_macs(h8, w8, chans, c_hid, n_segcls), nbytes)


def stem_bound(b: int, h: int, w: int, co: int, itemsize: int = 2) -> tuple:
    """K5 on (b, h, w, 3) -> (b, h/2, w/2, co): 108 taps a pixel and
    channel."""
    out_px = b * (h // 2) * (w // 2)
    nbytes = (b * h * w * 3 + out_px * co + 108 * co) * itemsize + 4 * co
    return bound_ms(2 * out_px * 108 * co, nbytes)


def served_stem_bound(b: int, h: int, w: int, co: int) -> tuple:
    """The served stem on (b, h, w, 3) uint8 -> (b, h/2, w/2, co) bf16:
    the image's bytes read once, the output written once, the bf16 tap
    matrix and the f32 scale and shift read once; 108 taps a pixel and
    channel."""
    out_px = b * (h // 2) * (w // 2)
    nbytes = b * h * w * 3 + (out_px * co + 112 * co) * 2 + 8 * co
    return bound_ms(2 * out_px * 108 * co, nbytes)


def seg_tail_bound(b: int, h: int, w: int, c: int, scale: int,
                   itemsize: int = 2) -> tuple:
    """K2 on (b, h, w, c) logits -> (b, h*scale, w*scale) uint8: two
    multiply-adds per output pixel and class for the separable bilinear
    blend and a compare per class, float32 on the CUDA cores."""
    out_px = b * h * scale * w * scale
    return bound_ms(out_px * (4 * c + c - 1), b * h * w * c * itemsize + out_px,
                    H100_F32_FLOPS)


def epilogue_bound(elems: int, c: int, act: bool, residual: bool,
                   itemsize: int = 2) -> tuple:
    """The fused conv epilogue (``csrc/conv_epilogue.cu``) in place over
    ``elems`` elements of ``c`` channels: y read and written once, the
    residual read, the 2c f32 constants read; a multiply-add an element,
    four operations more for the SiLU and one for the residual, float32 on
    the CUDA cores."""
    nbytes = elems * itemsize * (3 if residual else 2) + 8 * c
    flops = elems * (2 + (4 if act else 0) + (1 if residual else 0))
    return bound_ms(flops, nbytes, H100_F32_FLOPS)


def epilogue_phases_bound(b: int, h: int, w: int, c: int,
                          itemsize: int = 2) -> tuple:
    """The phase pass (``csrc/conv_epilogue.cu``) over the folded conv's
    (b, h+1, w+1, 4c) output -> (b, 2h, 2w, c): both tensors once and the
    2c f32 constants; per output element a product, a sum and four
    operations for the SiLU, float32 on the CUDA cores."""
    out = b * 4 * h * w * c
    nbytes = (b * 4 * (h + 1) * (w + 1) * c + out) * itemsize + 8 * c
    return bound_ms(6 * out, nbytes, H100_F32_FLOPS)


def nms_fused_bound(b: int, a: int, max_det: int, candidates: float,
                    picks: float) -> tuple:
    """K1 on six (b, a) f32 planes -> (b, max_det, 6): the score plane read
    whole, the other five only at an image's ``candidates`` (4 bytes a
    field, the least a read could fetch: the card moves 32-byte sectors, so
    scattered candidates cost it more), the output rows written once; each
    of an image's ``picks`` is tested against its ``candidates`` (this
    run's means per image)."""
    nbytes = 4 * (b * a + 5 * b * candidates + 6 * b * max_det)
    return bound_ms(b * picks * candidates * NMS_PAIR_FLOPS, nbytes,
                    H100_F32_FLOPS)


def mask_assembly_bound(b: int, hp: int, wp: int, nm: int, max_det: int,
                        kept: float, crop_px: float,
                        itemsize: int = 2) -> tuple:
    """The mask assembly over ``b`` images of (nm, hp, wp) prototypes in
    ``itemsize`` bytes -> (b, max_det, hp, wp / 8) bits: 2 nm operations
    (f32 on the CUDA cores) for each of the ``crop_px`` proto pixels inside
    the ``kept`` boxes' crops; the prototypes read once, nm f32
    coefficients a kept box, every bit row written once."""
    nbytes = b * nm * hp * wp * itemsize + 4 * nm * kept \
        + b * max_det * hp * wp / 8
    return bound_ms(2.0 * nm * crop_px, nbytes, H100_F32_FLOPS)


def nms_greedy_bound(b: int, k: int, max_det: int, live: float,
                     picks: float) -> tuple:
    """K3 on (b, k, 4) boxes and (b, k) scores -> (b, max_det) indices and
    scores: each of an image's ``picks`` is tested against its ``live``
    candidates (this run's means per image). The picks of an image are a
    chain of dependent steps, so no design comes near this bound."""
    nbytes = 4 * (5 * b * k + 2 * b * max_det)
    return bound_ms(b * picks * live * NMS_PAIR_FLOPS, nbytes, H100_F32_FLOPS)


def int8_conv_macs(b: int, ho: int, wo: int, cin: int, o: int, kh: int,
                   kw: int, groups: int = 1) -> int:
    """Multiply-adds of an int8 conv: every output pixel and channel over
    the taps of every input channel of its group (all parts together)."""
    return b * ho * wo * o * (cin // groups) * kh * kw


def int8_conv_bound(b: int, h: int, w: int, cin: int, ho: int, wo: int,
                    o: int, kh: int, kw: int, out_itemsize: int = 1,
                    residual: bool = False, groups: int = 1) -> tuple:
    """The int8 conv block on (b, h, w, cin) int8 parts -> (b, ho, wo, o)
    in ``groups`` groups: the parts, the int8 weights, the residual where
    there is one and the per-channel f32 constants read once, the output
    (int8, or the logits' ``out_itemsize``) written once; the products at
    the int8 tensor-core rate."""
    nbytes = (b * h * w * cin + o * (cin // groups) * kh * kw
              + (b * ho * wo * o if residual else 0)
              + b * ho * wo * o * out_itemsize + 4 * 6 * o)
    return bound_ms(2 * int8_conv_macs(b, ho, wo, cin, o, kh, kw, groups),
                    nbytes, H100_INT8_OPS)
