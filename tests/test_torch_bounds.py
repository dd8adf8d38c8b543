"""The pure-Python side of the kernels' records, on the CPU:

- the bound functions of ``desenet_tpu_torch.tools.timing`` (the least time
  an H100 could take: bytes over 3.35 TB/s or operations over the peak rate
  of their type) against figures worked out by hand from the shapes;
- K6's tile choice (``ops.c3_fused.pick_tile``) on yolov5s_seg's eight
  served C3 rows: every tile divides its map, fits a block's 227 KB of
  shared memory together with the weight ring, and computes no more
  multiply-adds than the CUDA-core kernel's square tile (fewer in total and
  at the n = 3 and 20 x 20 rows);
- the kernel each wrapper would launch (tensor cores or CUDA cores) for the
  served rows, for a c_ of 8, and for the seg head's nine convs;
- K4's FFM conv over ``[spatial | ctx]`` with ctx padded to a multiple of 16
  channels (zero channels, zero weight rows) equal to the unpadded one.
"""

import numpy as np
import pytest
import torch
import torch.nn.functional as F

from desenet_tpu_torch.ops import c3_fused, seg_head_pallas
from desenet_tpu_torch.testing import C3_SERVED
from desenet_tpu_torch.tools import timing as tm

# bound in ms at b128/640 bf16 and what binds, per served row
C3_BOUNDS = {2: (0.25, "bytes"), 4: (0.26, "operations"),
             6: (0.26, "operations"), 9: (0.12, "operations"),
             13: (0.15, "operations"), 17: (0.19, "bytes"),
             20: (0.12, "operations"), 23: (0.12, "operations")}


def test_bound_ms_takes_the_larger():
    assert tm.bound_ms(989e12, 0) == (1000.0, "operations")
    assert tm.bound_ms(0, 3.35e12) == (1000.0, "bytes")
    ms, by = tm.bound_ms(67e12, 3.35e12, tm.H100_F32_FLOPS)
    assert by == "bytes" and ms == 1000.0  # a tie counts as bytes
    assert tm.bound_ms(2 * 67e12, 3.35e12, tm.H100_F32_FLOPS) == \
        (2000.0, "operations")


def test_c3_bounds_of_the_served_rows():
    macs = sum(tm.c3_macs(128, s, s, c, c_, c2, n)
               for _, c, c2, c_, n, _, s in C3_SERVED)
    assert macs == 644_245_094_400  # 644.2 G
    io = sum(128 * s * s * (c + c2) * 2 for _, c, c2, _, _, _, s in C3_SERVED)
    assert io == pytest.approx(2.83e9, rel=2e-3)
    total = 0.0
    for row, c, c2, c_, n, _, s in C3_SERVED:
        ms, by = tm.c3_bound(128, s, s, c, c_, c2, n)
        assert by == C3_BOUNDS[row][1], row
        assert ms == pytest.approx(C3_BOUNDS[row][0], abs=0.006), row
        total += ms
    assert total == pytest.approx(1.47, abs=0.005)
    # all operations: 1.288 PFLOP at 989 TFLOP/s
    assert 2 * macs / tm.H100_BF16_FLOPS * 1e3 == pytest.approx(1.30, abs=0.005)


@pytest.mark.parametrize("b,side,co,want", [
    (128, 640, 32, 0.297),   # s: 157.3 MB of uint8 in, 838.9 MB out
    (128, 640, 64, 0.548),   # l: 1677.7 MB out
    (32, 1280, 80, 0.673)])  # x6: 2097.2 MB out
def test_served_stem_bounds(b, side, co, want):
    ms, by = tm.served_stem_bound(b, side, side, co)
    assert by == "bytes" and ms == pytest.approx(want, abs=0.0005)
    assert ms == pytest.approx(
        (b * side * side * 3 + 2 * b * (side // 2) ** 2 * co) / 3.35e12
        * 1e3, rel=1e-5)


def test_other_kernels_bounds():
    ms, by = tm.stem_bound(128, 640, 640, 32)
    assert by == "bytes" and ms == pytest.approx(0.35, abs=0.006)  # 1.15 GB
    ms, by = tm.seg_tail_bound(128, 80, 80, 3, 8)
    assert by == "bytes" and ms == pytest.approx(0.017, abs=0.0005)
    # K1 reads the score plane whole (12.9 MB) and the five other fields at
    # the candidates only (0.64 MB), and writes 0.92 MB of rows
    ms, by = tm.nms_fused_bound(128, 25200, 300, 250.0, 100.0)
    assert by == "bytes" and ms == pytest.approx(0.00432, abs=0.00005)
    assert ms == pytest.approx(
        4 * 128 * (25200 + 5 * 250 + 6 * 300) / 3.35e12 * 1e3, rel=1e-9)
    # a dense decode: 100 picks against 3000 candidates an image are 0.61
    # GFLOP of f32, more time than its 21.5 MB
    ms, by = tm.nms_fused_bound(128, 25200, 300, 3000.0, 100.0)
    assert by == "operations" and ms == pytest.approx(0.00917, abs=0.00005)
    # K3: 10 MB move in 0.003 ms, but 300 picks against 7200 live
    # candidates an image are 1.1 GFLOP of f32 on the CUDA cores
    ms, by = tm.nms_greedy_bound(32, 16384, 300, 7200.0, 300.0)
    assert by == "operations" and ms == pytest.approx(0.0165, abs=0.0005)
    ms, by = tm.nms_greedy_bound(32, 16384, 300, 100.0, 10.0)
    assert by == "bytes" and ms == pytest.approx(0.0031, abs=0.0002)
    # K4 at yolov5s_seg's widths: about 4.7 GFLOP and 4.5 MB an image
    chans = (256, 256, 512)
    assert 2 * tm.psp2_macs(80, 80, chans, 128, 3) == \
        pytest.approx(4.7e9, rel=0.01)
    ms, by = tm.psp2_bound(32, 80, 80, chans, 128, 3)
    assert by == "operations" and ms == pytest.approx(0.152, abs=0.002)
    assert tm.bound_ms(0, 32 * 4.5e6)[0] == pytest.approx(0.043, abs=0.001)


def test_int8_conv_bounds():
    """The int8 conv block: a 3x3 of 128 channels at 80x80, b32, is 60.4
    GOP (0.0305 ms at 1979 TOP/s) against 52.6 MB (0.0157 ms); a 1x1 of
    64 channels at 160x160 moves 105 MB (0.0313 ms) for 6.7 GOP."""
    assert tm.int8_conv_macs(32, 80, 80, 128, 128, 3, 3) == 32 * 6400 * 128 \
        * 128 * 9
    ms, by = tm.int8_conv_bound(32, 80, 80, 128, 80, 80, 128, 3, 3)
    assert by == "operations" and ms == pytest.approx(0.0305, abs=0.0002)
    ms, by = tm.int8_conv_bound(32, 160, 160, 64, 160, 160, 64, 1, 1)
    assert by == "bytes" and ms == pytest.approx(0.0313, abs=0.0002)
    # a residual is read once more; f32 logits are written 4 bytes each
    with_res = tm.int8_conv_bound(32, 160, 160, 64, 160, 160, 64, 1, 1,
                                  residual=True)[0]
    assert with_res == pytest.approx(ms * 1.5, rel=0.001)
    logits = tm.int8_conv_bound(32, 80, 80, 128, 80, 80, 19, 1, 1, 4)[0]
    assert logits == pytest.approx(
        (32 * 6400 * (128 + 19 * 4) + 19 * 128 + 4 * 6 * 19) / 3.35e12 * 1e3,
        rel=1e-9)


def test_int8_conv_grouped_bounds():
    """A grouped conv does 1/g of the dense conv's products and reads 1/g
    of its weights: the 3x3 of 128 channels above at g 2 is 30.2 GOP, now
    under its 52.6 MB; depthwise (g 128) at b8 moves 6.6 MB (0.0039 ms,
    testing.INT8_GROUPED_CASES' dw_3x3_s1) for 0.094 GOP."""
    assert tm.int8_conv_macs(32, 80, 80, 128, 128, 3, 3, 2) * 2 == \
        tm.int8_conv_macs(32, 80, 80, 128, 128, 3, 3)
    ms, by = tm.int8_conv_bound(32, 80, 80, 128, 80, 80, 128, 3, 3,
                                groups=2)
    assert by == "bytes" and ms == pytest.approx(
        (32 * 6400 * 256 + 128 * 64 * 9 + 4 * 6 * 128) / 3.35e12 * 1e3,
        rel=1e-9)
    ms, by = tm.int8_conv_bound(8, 80, 80, 128, 80, 80, 128, 3, 3,
                                groups=128)
    assert by == "bytes" and ms == pytest.approx(0.0039, abs=0.0001)
    assert tm.int8_conv_macs(8, 80, 80, 128, 128, 3, 3, 128) == \
        8 * 6400 * 128 * 9


def test_psp2_macs_counts_the_folded_weights():
    """The count, term by term, from a folded head's weight shapes."""
    from desenet_tpu_torch.testing import random_psp2_head

    c_hid, chans, h8 = 48, (32, 64, 96), 8
    f = seg_head_pallas.fold_head(random_psp2_head(chans, c_hid))
    p8, p16, p32 = h8 * h8, (h8 // 2) ** 2, (h8 // 4) ** 2
    inner, n_red, n4 = 3 * c_hid // 6, c_hid // 6, c_hid // 6 // 4
    assert f["b0b"][0].shape == (3, 3, inner, inner)
    assert f["red"][0].shape == (3 * c_hid, n_red)
    assert f["pp1"][0].shape == (n_red, n4)
    assert f["cb"][0].shape == (3, 3, c_hid + 4 * n4, c_hid)

    def numel(key):
        return f[key][0].numel() if isinstance(f[key], tuple) else \
            f[key].numel()

    per_pixel = (numel("m8") + c_hid * inner + numel("b0b") + numel("b1")
                 + numel("b2") + 3 * inner * c_hid + c_hid * n_red
                 + numel("cb") + numel("out"))
    want = (p8 * per_pixel
            + p16 * numel("m16") + p32 * numel("m32")
            + (p16 + p32) * c_hid * (inner + n_red)      # the 1x1 slices
            + 8 * p8 * (inner + n_red)                   # two upsamples
            + numel("g") + inner * c_hid                 # global branch
            + 49 * p8 * n_red + 49 * p8 * n4             # pools, unpools
            + numel("pp1") + 49 * n_red * n4             # pyramid convs
            + numel("fc1") + numel("fc2"))
    assert tm.psp2_macs(h8, h8, chans, c_hid, 3) == want


def test_pick_tile_on_the_served_rows():
    new_total = old_total = 0
    for row, c, c2, c_, n, _, side in C3_SERVED:
        th, tw = c3_fused.pick_tile(side, side, c, c_, c2, n)
        assert side % th == 0 and side % tw == 0, (row, th, tw)
        assert c3_fused.mma_smem_bytes(th, tw, c_, n) <= 227 * 1024
        assert c3_fused.mma_smem_bytes(th, tw, c_, n) == \
            4 * (th + 2 * n) * (tw + 2 * n) * (c_ + 8) + 74752
        old = c3_fused.pick_square_tile(c_, n, 2)  # the CUDA-core kernel's
        new_macs = c3_fused.c3_macs(side, side, c, c_, c2, n, th, tw)
        old_macs = c3_fused.c3_macs(side, side, c, c_, c2, n, old, old)
        assert new_macs <= old_macs, row
        if n == 3 or side == 20:
            assert new_macs < 0.95 * old_macs, row
        assert new_macs >= tm.c3_macs(1, side, side, c, c_, c2, n)
        new_total += 128 * new_macs
        old_total += 128 * old_macs
    assert old_total == pytest.approx(899e9, rel=1e-3)
    assert new_total < 0.86 * old_total
    # the rows the CUDA-core kernel cut into 8 x 8 tiles (3 x 3 of them
    # cover 24 x 24 of a 20 x 20 map)
    assert c3_fused.pick_tile(20, 20, 512, 256, 512, 1) == (10, 10)
    assert c3_fused.pick_tile(80, 80, 128, 64, 128, 3) == (16, 16)


def test_pick_tile_on_other_maps():
    # no halo to recompute without bottlenecks' 3x3: the whole map if it fits
    assert c3_fused.pick_tile(7, 9, 128, 32, 64, 2) == (7, 9)
    # prime sides: a ragged tile beats 1 x 1, the only one that divides
    th, tw = c3_fused.pick_tile(83, 83, 512, 256, 512, 1)
    assert th * tw > 40
    assert c3_fused.mma_smem_bytes(th, tw, 256, 1) <= c3_fused.SMEM_BLOCK
    assert c3_fused.c3_macs(20, 20, 64, 32, 64, 0, 20, 20) == \
        tm.c3_macs(1, 20, 20, 64, 32, 64, 0)


def test_c3_variant_by_dtype_and_widths():
    for _, c, c2, c_, _, _, _ in C3_SERVED:
        assert c3_fused.pick_variant(torch.bfloat16, c, c_, c2) == "mma"
        assert c3_fused.pick_variant(torch.float32, c, c_, c2) == "fma"
    assert c3_fused.pick_variant(torch.bfloat16, 16, 8, 16) == "fma"  # c_ 8
    assert c3_fused.pick_variant(torch.bfloat16, 24, 16, 32) == "fma"
    assert c3_fused.pick_variant(torch.bfloat16, 32, 16, 48) == "mma"


def test_psp2_conv_variants_at_s_width():
    bf, inner, c_hid = torch.bfloat16, 64, 128
    # (c1, c2, O, input pitches, output pitch) of the nine conv launches
    convs = [(256, 0, c_hid, (256,), c_hid), (c_hid, 0, inner, (c_hid,), inner),
             (inner, 0, inner, (inner,), 192), (inner, 0, inner, (192,), 192),
             (inner, 0, inner, (192,), 192), (192, 0, c_hid, (192,), c_hid),
             (c_hid, 0, 21, (c_hid,), 21), (c_hid, 32, c_hid, (c_hid, 32), c_hid),
             (c_hid, 0, 3, (c_hid,), 3)]
    taps = [1, 1, 3, 3, 3, 1, 1, 3, 1]
    got = [seg_head_pallas.conv_variant(bf, c1, c2, o, lds, old, t)
           for (c1, c2, o, lds, old), t in zip(convs, taps)]
    assert got == ["mma"] * 6 + ["narrow", "mma", "narrow"]
    f32 = [seg_head_pallas.conv_variant(torch.float32, c1, c2, o, lds, old, t)
           for (c1, c2, o, lds, old), t in zip(convs, taps)]
    assert f32 == ["fma"] * 6 + ["narrow", "fma", "narrow"]
    # the FFM conv with ctx unpadded (20 channels) could not run on the
    # tensor cores; a 3x3 or a second input rules the narrow kernel out
    assert seg_head_pallas.conv_variant(bf, c_hid, 20, c_hid, (c_hid, 20),
                                        c_hid, 3) == "fma"
    assert seg_head_pallas.conv_variant(bf, c_hid, 0, 21, (c_hid,), 21,
                                        3) == "fma"
    assert seg_head_pallas.conv_variant(bf, 12, 0, 3, (12,), 3) == "fma"


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_ffm_conv_padded_ctx_equals_unpadded(dtype):
    rng = np.random.default_rng(0)
    b, h8, w8, c_hid, nctx = 2, 6, 5, 128, 20
    spatial = torch.from_numpy(rng.normal(size=(b, h8 * w8, c_hid)).astype(
        np.float32)).to(dtype)
    ctx = torch.from_numpy(rng.normal(size=(b, h8 * w8, nctx)).astype(
        np.float32)).to(dtype)
    # folded weights carry unused input rows past c_hid + nctx
    wcb = torch.from_numpy(rng.normal(size=(3, 3, c_hid + nctx + 1, c_hid))
                           .astype(np.float32) / 36).to(dtype)
    bias = torch.from_numpy(rng.normal(size=c_hid).astype(np.float32))
    want = seg_head_pallas._conv3x3_plain(
        spatial, wcb[:, :, 0:c_hid], bias, 1, h8, w8, extra=ctx,
        w2=wcb[:, :, c_hid:c_hid + nctx])
    wpad = seg_head_pallas.pad_ffm_weights(wcb, c_hid, nctx)
    assert wpad.shape == (9 * (c_hid + 32), c_hid)
    wpad = wpad.reshape(3, 3, c_hid + 32, c_hid)
    assert not wpad[:, :, c_hid + nctx:].any()
    ctx_pad = F.pad(ctx, (0, 12))
    got = seg_head_pallas._conv3x3_plain(
        spatial, wpad[:, :, 0:c_hid], bias, 1, h8, w8, extra=ctx_pad,
        w2=wpad[:, :, c_hid:])
    assert torch.equal(got, want)


def test_epilogue_bound():
    # x6's stem output at b32/1280 in bf16: 1.05 G elements read and
    # written, 4.19 GB at 3.35 TB/s
    n = 32 * 80 * 640 * 640
    ms, by = tm.epilogue_bound(n, 80, True, False)
    assert by == "bytes" and ms == pytest.approx(1.2521, abs=0.0001)
    # with the shortcut a third read: 6 bytes an element
    ms, by = tm.epilogue_bound(n // 4, 80, True, True)
    assert by == "bytes" and ms == pytest.approx(
        (n // 4 * 6 + 640) / 3.35e12 * 1e3, rel=1e-12)
    # f32 without the SiLU: 8 bytes and 2 operations an element
    ms, by = tm.epilogue_bound(1000, 10, False, False, itemsize=4)
    assert by == "bytes" and ms == pytest.approx(
        (8000 + 80) / 3.35e12 * 1e3, rel=1e-12)


def test_epilogue_phases_bound():
    # Proto's cv2 at b128/640 in bf16: the folded conv's (128, 81, 81,
    # 1280) output read, the (128, 160, 160, 320) map written, 4.247 GB
    ms, by = tm.epilogue_phases_bound(128, 80, 80, 320)
    assert by == "bytes" and ms == pytest.approx(1.2678, abs=0.0001)
    # f32, one pixel: 4 (2 x 2 x 4c) read, 4c written, 4 bytes each
    ms, by = tm.epilogue_phases_bound(1, 1, 1, 10, itemsize=4)
    assert by == "bytes" and ms == pytest.approx(
        ((160 + 40) * 4 + 80) / 3.35e12 * 1e3, rel=1e-12)
