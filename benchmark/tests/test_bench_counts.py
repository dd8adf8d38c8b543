"""The frozen yardstick against figures worked out by hand."""

import pytest

from benchmark.counts import bounds
from benchmark.counts.flops import forward_flops, train_flops


def test_seg_tail_bound_by_hand():
    # 128 x 640 x 640 output pixels; 3 classes: 4 * 3 + 2 = 14 FLOPs each
    # = 734,003,200 FLOPs over 67e12 = 10.955 us; bytes: logits 128 * 80 *
    # 80 * 3 * 2 = 4,915,200 plus the map 52,428,800 = 57,344,000 over
    # 3.35e12 = 17.118 us: bytes bound it
    ms, by = bounds.seg_tail_bound(128, 80, 80, 3, 8)
    assert by == "bytes"
    assert ms == pytest.approx(57_344_000 / 3.35e12 * 1e3)
    assert ms == pytest.approx(0.0171176, rel=1e-5)


def test_nms_fused_bound_by_hand():
    # bytes 4 * (128 * 25200 + 5 * 128 * 200 + 6 * 128 * 300)
    # = 4 * (3,225,600 + 128,000 + 230,400) = 14,336,000 -> 4.2794 us;
    # operations 128 * 100 * 200 * 16 = 40,960,000 -> 0.611 us
    ms, by = bounds.nms_fused_bound(128, 25200, 300, 200, 100)
    assert by == "bytes"
    assert ms == pytest.approx(14_336_000 / 3.35e12 * 1e3)
    # a saturated decode: the picks' tests bound it
    ms, by = bounds.nms_fused_bound(128, 25200, 300, 24800, 300)
    assert by == "operations"
    assert ms == pytest.approx(128 * 300 * 24800 * 16 / 67e12 * 1e3)


TINY = {
    "de_nc": 1, "se_nc": 2, "depth_multiple": 1.0, "width_multiple": 1.0,
    "anchors": [[10, 13, 16, 30]],
    "backbone": [[-1, 1, "Focus", [8, 3]],
                 [-1, 1, "Conv", [16, 3, 2]]],
    "head": [[[1, 1, 1], 1, "SegMaskPSP2", ["se_nc", 1, 48]],
             [[1], 1, "Detect", ["de_nc", "anchors"]]],
}


def test_forward_flops_by_hand():
    # 32x32 input. Focus: 12 -> 8, 3x3 at 16x16: 2*12*8*9*256 = 442,368.
    # Conv: 8 -> 16, 3x3 s2 at 8x8: 2*8*16*9*64 = 147,456.
    # Seg head at 8x8 (P = 64), c_hid 48, inter 24, c_ctx 8, 2 a branch:
    #   stems 3 x 2*16*48*64 = 294,912; branch0 2*144*24*64 = 442,368 and
    #   2*24*24*9*64 = 663,552; branch1, branch2 2 x 663,552; global
    #   2*24*24 = 1,152; ConvLinear 2*96*48*64 = 589,824; context 2*144*8*64
    #   = 147,456; pyramid 2*8*2*(1+4+9+36) = 1,600; ffm 2*(48+8)*48*9*64
    #   = 3,096,576; attention 2 x 2*48*48 = 9,216; out 2*48*2*64 = 12,288.
    # Detect: 16 -> 2 * 6 = 12, 1x1 at 8x8: 2*16*12*64 = 24,576.
    want = (442_368 + 147_456 + 294_912 + 442_368 + 663_552 * 3 + 1_152
            + 589_824 + 147_456 + 1_600 + 3_096_576 + 9_216 + 12_288
            + 24_576)
    assert forward_flops(TINY, 32, 32) == want
    assert train_flops(TINY, 32, 32) == 3 * want
