"""The CUDA kernels K1 (csrc/nms_fused.cu), K2 (csrc/seg_tail.cu), K3
(csrc/nms_greedy.cu), K4 (csrc/seg_head_psp2.cu), K5 (csrc/stem_conv.cu),
K6 (csrc/c3_fused.cu) and the int8 conv block (csrc/int8_conv.cu) against
their plain PyTorch versions, on the card. Each test skips without
a CUDA device (decided in the fixture, never at import). Run on the card:

    python -m pytest --noconftest tests/test_torch_kernels_cuda.py -q

(``--noconftest``: tests/conftest.py imports JAX, which the card's machine
need not have.)

K1-K3 do the plain versions' f32 arithmetic in the same order with no
fused multiply-adds, so the results must be equal: K1 on every case of
``testing.NMS_FUSED_CASES`` (counts on and beside its caps, ties, duplicates,
the dense decode) with the path each image took checked, K2 on every case of
``testing.SEG_TAIL_CASES`` with the kernel the wrapper picked checked and the
two kernels held side by side, K3 on sorted sets (its ordered walk) and
unsorted ones (its argmax loop), on the shared-memory and
the global-scratch size, with the path each image took checked. K4 sums its products in
another order than the plain version's matmuls: it is held to
``desenet_tpu_torch.testing.check_psp2``'s bars (f32 at rtol/atol 1e-4 with
TF32 off; bf16 within 1e-2 of the largest plain logit and class decisions
equal on at least 99% of positions). K5 and K6 also sum in another order
than their plain versions: f32 (TF32 off) at rtol/atol 1e-5 (K5, 108
products a pixel, as tests/test_stem_pallas.py holds the TPU kernel; the
CUDA-core kernel; bf16 takes the tensor-core kernel) and
1e-4 (K6, sums up to 2304 long through a chain of five products); bf16 at
``desenet_tpu_torch.testing.check_bf16``'s bar. The inputs come from
``desenet_tpu_torch.testing``, as chip_smoke.py's do.

In bfloat16 K6 and K4's convs run on the tensor cores where their widths
allow (csrc/mma_bf16.cuh): the shared tile is held alone against
``torch.matmul`` in f32 (both sum exact bf16 products in f32, so rtol/atol
1e-4 of values of order 1), K6 at ragged maps, at rows 9/23's widths and at
channel counts that are no multiple of 64, K4 at yolov5s_seg's width on a
map that is no multiple of the block's 128 pixels; each test also checks
which kernel the wrapper launched.

The int8 conv block runs on ``testing.INT8_CONV_CASES`` (the FusedFocus
stem's 3 channels at 6x6/s2, a 3x3/s2 backbone conv, a bottleneck with its
residual read as channel slices, a 4-part SPP concat, a per-tensor 2-part
concat, a d=3 dilated conv of 21 channels, the class conv's f32 and bf16
logits) and ``testing.INT8_GROUPED_CASES`` (g 2 and 4, depthwise 3x3 and
5x5, k 1 and 3, stride 1 and 2, one with its residual read from a slice):
its int32 sums bit-equal to the plain version's float64 conv, its outputs
at ``testing.check_int8``'s bar.

K1's anchor index (``return_index``, a Segment model's masks read their
coefficients there) equals the plain versions' on every case of
``testing.NMS_FUSED_CASES``, and the rows with it equal those without. The
mask assembly (csrc/mask_assembly.cu) sums its 32 products in another order
than the plain version's matmul: on ``testing.MASK_CASES`` (bf16 and f32
prototypes; the last the served cell's b128 at 640) its bits equal the
plain version's except where ``|c . P|`` is below 1e-3 of its median
(``testing.check_masks``).

The phase pass (csrc/conv_epilogue.cu ``desenet_conv_epilogue_phases``,
Proto's upsample and 3x3 conv as one folded 2x2 conv) does the plain
version's arithmetic op for op: on ``testing.PHASE_CASES`` in bf16 and f32,
on the 16-byte and the one-element path (and a y off 16-byte alignment),
its output equals the plain version's bit for bit; each refusal of
``testing.PHASE_REFUSALS`` is a ValueError and launches nothing; Proto at
the x7seg cell's widths (``testing.PROTO_SERVED``, b2) takes the phase path
and agrees with the upsample and 3x3 conv at ``check_close``'s bars.

The training step (no kernel of its own) is held against itself on the
CPU, as chip_smoke.py's phase 7(a) holds it: the tiny model's SGD steps on
the card and on the CPU (``testing.TRAIN_PARITY_STEPS``: two in float64, one
in float32 with TF32 off), fused and materialized seg loss, at
``testing.TRAIN_LOSS_BAR`` / ``TRAIN_STATE_BAR``.
"""

import numpy as np
import pytest
import torch

from desenet_tpu_torch.ops import (c3_fused, conv_epilogue, int8_conv,
                                   mask_assembly, nms_fused, nms_pallas,
                                   seg_head_pallas, seg_pallas, stem_pallas)
from desenet_tpu_torch.testing import (C3_SERVED, INT8_CONV_CASES,
                                       INT8_GROUPED_CASES, MASK_CASES,
                                       NMS_FUSED_CASES, PHASE_CASES,
                                       PHASE_REFUSALS, PROTO_SERVED,
                                       check_masks, phases_case,
                                       phases_refusal_case,
                                       mask_assembly_case,
                                       SEG_TAIL_CASES, check_close,
                                       check_psp2, dense_decode,
                                       dense_sorted_candidates,
                                       greedy_candidates, nms_fused_case,
                                       no_tf32, psp2_inputs,
                                       random_c3_params, random_psp2_head,
                                       seg_tail_infinite_input,
                                       seg_tail_input, select_planes,
                                       sorted_candidates, stem_inputs,
                                       synthetic_decode, train_parity,
                                       check_train_parity, check_int8,
                                       int8_conv_case)

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


@pytest.fixture
def full_f32():
    with no_tf32():
        yield


@pytest.mark.parametrize("frac", [0.0, 0.01, 0.8])  # none, sparse, > smem cap
def test_nms_kernel_matches_plain(cuda, frac):
    pred = synthetic_decode(np.random.default_rng(0), 4, 25200, 6, frac)
    planes = nms_fused.nms_planes(torch.from_numpy(pred).to(cuda), 0.25)
    before = nms_fused.launches
    got = nms_fused.greedy_select(*planes, 300, 0.45)
    assert nms_fused.launches == before + 1
    want = nms_fused.greedy_select_plain(*planes, 300, 0.45)
    torch.cuda.synchronize()
    assert torch.equal(got, want)


@pytest.mark.parametrize("b,c,dtype", [(4, 3, torch.float32),
                                       (4, 3, torch.bfloat16),
                                       (2, 19, torch.float32)])
def test_seg_tail_kernel_matches_plain(cuda, b, c, dtype):
    x = torch.randn((b, 80, 80, c), generator=torch.Generator().manual_seed(0)
                    ).to(cuda, dtype)
    taps = (*seg_pallas.seg_taps(80, 640, True, cuda),
            *seg_pallas.seg_taps(80, 640, True, cuda))
    before = seg_pallas.launches
    got = seg_pallas.upsample_argmax(x, 8, True)
    assert seg_pallas.launches == before + 1
    want = seg_pallas.upsample_argmax_plain(x, *taps)
    torch.cuda.synchronize()
    assert torch.equal(got, want)


@pytest.mark.parametrize("case", NMS_FUSED_CASES, ids=lambda c: c[0])
def test_nms_kernel_cases(cuda, case):
    """K1 on the cases chip_smoke.py runs: rows equal to plain, and the
    path every image took."""
    _, _, _, max_det, path = case
    planes = [p.to(cuda) for p in nms_fused_case(case)]
    before = nms_fused.launches
    got = nms_fused.greedy_select(*planes, max_det, 0.45)
    assert nms_fused.launches == before + 1
    want = nms_fused.greedy_select_plain(*planes, max_det, 0.45)
    torch.cuda.synchronize()
    assert torch.equal(got, want)
    assert nms_fused.last_paths.tolist() == [path] * planes[4].shape[0]


@pytest.mark.parametrize("case", NMS_FUSED_CASES, ids=lambda c: c[0])
def test_nms_kernel_index_cases(cuda, case):
    """K1 with each pick's anchor: the anchors equal the plain version's,
    the rows those without."""
    _, _, _, max_det, path = case
    planes = [p.to(cuda) for p in nms_fused_case(case)]
    got, idx = nms_fused.greedy_select(*planes, max_det, 0.45,
                                       return_index=True)
    rows = nms_fused.greedy_select(*planes, max_det, 0.45)
    want, want_idx = nms_fused.greedy_select_plain(*planes, max_det, 0.45,
                                                   return_index=True)
    torch.cuda.synchronize()
    assert torch.equal(got, rows) and torch.equal(got, want)
    assert torch.equal(idx, want_idx)
    assert nms_fused.last_paths.tolist() == [path] * planes[4].shape[0]


@pytest.mark.parametrize("case", MASK_CASES, ids=lambda c: f"b{c[0]}_{c[3]}")
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_mask_assembly_kernel_matches_plain(cuda, case, dtype):
    decode, index, boxes, num, proto, nc, hw = mask_assembly_case(
        case, dtype=dtype)
    want = mask_assembly.assemble_masks_plain(decode, index, boxes, num,
                                              proto, nc, hw)
    before = mask_assembly.launches
    got = mask_assembly.assemble_masks(
        decode.to(cuda), index.to(cuda), boxes.to(cuda), num.to(cuda),
        proto.to(cuda).contiguous(memory_format=torch.channels_last), nc, hw)
    assert mask_assembly.launches == before + 1
    flips, _ = check_masks(got, want, decode, index, num, proto, nc)
    assert flips <= 1e-6 * want.numel() * 8


def test_nms_kernel_paths_chosen_per_image(cuda):
    """Images under and over the candidate cap in one batch."""
    rng = np.random.default_rng(4)
    few = select_planes(rng, 1, 25200, 300)
    many = select_planes(rng, 1, 25200, nms_fused.CAND_CAP + 1)
    planes = [torch.cat([a, b, a]).to(cuda) for a, b in zip(few, many)]
    got = nms_fused.greedy_select(*planes, 300, 0.45)
    want = nms_fused.greedy_select_plain(*planes, 300, 0.45)
    torch.cuda.synchronize()
    assert torch.equal(got, want)
    assert nms_fused.last_paths.tolist() == [
        nms_fused.PATH_ORDERED, nms_fused.PATH_ARGMAX, nms_fused.PATH_ORDERED]


def test_nms_ordered_plain_on_the_card(cuda):
    """The plain form of K1's ordered path, on CUDA tensors, at the kernel's
    own round and survivor sizes, on a dense decode."""
    pred = dense_decode(np.random.default_rng(6), 2, 25200, 6, 3000, 100)
    planes = nms_fused.nms_planes(torch.from_numpy(pred).to(cuda), 0.25)
    got = nms_fused.greedy_select_ordered_plain(*planes, 300, 0.45)
    want = nms_fused.greedy_select(*planes, 300, 0.45)
    assert torch.equal(got, want)
    assert (want[..., 4] > 0).sum(1).tolist() == [100, 100]  # one an object


@pytest.mark.parametrize(
    "case", SEG_TAIL_CASES,
    ids=lambda c: f"{c[0]}x{c[1]}x{c[2]}x{c[3]}-{str(c[4])[6:]}-s{c[5]}-"
                  f"{'align' if c[6] else 'half'}-{c[7]}")
def test_seg_tail_kernel_cases(cuda, case):
    """K2 on the cases chip_smoke.py runs: the kernel the wrapper picks, and
    both kernels equal to plain."""
    b, h, w, c, dtype, scale, align, variant = case
    x = seg_tail_input(case).to(cuda)
    taps = (*seg_pallas.seg_taps(h, h * scale, align, cuda),
            *seg_pallas.seg_taps(w, w * scale, align, cuda))
    before = seg_pallas.launches
    got = seg_pallas.upsample_argmax(x, scale, align)
    assert seg_pallas.launches == before + 1
    assert seg_pallas.last_variant == variant
    want = seg_pallas.upsample_argmax_plain(x, *taps)
    pixel = seg_pallas.upsample_argmax_with(x, "pixel", scale, align)
    torch.cuda.synchronize()
    assert got.shape == (b, h * scale, w * scale) and got.dtype == torch.uint8
    assert torch.equal(got, want) and torch.equal(pixel, want)
    if variant == "pixel":
        with pytest.raises(ValueError, match="does not take"):
            seg_pallas.upsample_argmax_with(x, "span", scale, align)


def test_seg_tail_kernels_keep_infinite_neighbours_out(cuda):
    """A one-tap pixel reads its own source only, as plain does: an infinite
    logit in the next column or row reaches neither kernel's answer there."""
    x = seg_tail_infinite_input().to(cuda)
    taps = seg_pallas.seg_taps(80, 640, True, cuda) * 2
    want = seg_pallas.upsample_argmax_plain(x, *taps)
    assert torch.equal(seg_pallas.upsample_argmax_with(x, "span"), want)
    assert torch.equal(seg_pallas.upsample_argmax_with(x, "pixel"), want)
    assert not bool((want[:, :, 0] == 2).all())    # column 1's +inf kept out
    assert bool((want[:, 1:8, 1] == 2).all())      # and met one pixel on


def test_seg_tail_kernel_ties_go_to_the_first_channel(cuda):
    x = torch.ones((2, 80, 80, 4), device=cuda)
    assert int(seg_pallas.upsample_argmax(x).max()) == 0
    assert seg_pallas.last_variant == "span"


@pytest.mark.parametrize("b,k", [(4, 2048), (2, nms_pallas.SMEM_CAP + 5000)])
def test_greedy_nms_kernel_matches_plain(cuda, b, k):
    boxes, scores = (t.to(cuda) for t in
                     greedy_candidates(np.random.default_rng(k), b, k))
    before = nms_pallas.launches
    idx, sc = nms_pallas.greedy_nms_pallas(boxes, scores, 0.6, 300)
    assert nms_pallas.launches == before + 1
    want_idx, want_sc = nms_pallas.greedy_nms_plain(boxes, scores, 0.6, 300)
    torch.cuda.synchronize()
    assert int((sc > 0).sum()) > 0
    assert torch.equal(idx, want_idx) and torch.equal(sc, want_sc)
    # an unsorted set: every image took the argmax loop
    assert nms_pallas.last_paths.tolist() == [nms_pallas.PATH_ARGMAX] * b


def assert_greedy_equal(cuda, boxes, scores, iou, max_det, path):
    """K3 on the card against greedy_nms_plain, and the path every image
    took."""
    boxes, scores = boxes.to(cuda), scores.to(cuda)
    before = nms_pallas.launches
    idx, sc = nms_pallas.greedy_nms_pallas(boxes, scores, iou, max_det)
    assert nms_pallas.launches == before + 1
    want_idx, want_sc = nms_pallas.greedy_nms_plain(boxes, scores, iou,
                                                    max_det)
    torch.cuda.synchronize()
    assert torch.equal(idx, want_idx) and torch.equal(sc, want_sc)
    assert nms_pallas.last_paths.tolist() == [path] * scores.shape[0]
    return sc


# sorted sets, as the validation path's top-k hands them over: (K, live,
# max_det, generator arguments). L on and off the round (1024) and the
# survivor (512) boundaries, ties, duplicate boxes, all dead, fewer live than
# max_det, a crowded set (most suppressed), the global-scratch size
SORTED_CASES = [
    (2048, 1500, 300, {}),
    (2048, 1024, 300, {}), (2048, 1025, 300, {}), (2048, 1023, 2000, {}),
    (2048, 512, 2000, {}), (2048, 513, 2000, {}), (2048, 511, 2000, {}),
    (4096, 4096, 2048, {}),
    (2048, 1500, 300, {"levels": 5}), (2048, 1500, 2000, {"levels": 40}),
    (2048, 1500, 300, {"dup": 0.5}), (2048, 1500, 2000, {"dup": 0.9}),
    (2048, 0, 300, {}), (2048, 1, 300, {}), (2048, 100, 300, {}),
    (4096, 3000, 300, {"spread": 500.0}),
    (4096, 3000, 2000, {"spread": 1200.0, "levels": 9}),
    (nms_pallas.SMEM_CAP + 5000, 9000, 300, {"spread": 4000.0}),
]


@pytest.mark.parametrize("k,live,max_det,kw", SORTED_CASES)
def test_greedy_nms_ordered_walk_matches_plain(cuda, k, live, max_det, kw):
    rng = np.random.default_rng(k + live)
    boxes, scores = sorted_candidates(rng, 3, k, live, **kw)
    sc = assert_greedy_equal(cuda, boxes, scores, 0.6, max_det,
                             nms_pallas.PATH_ORDERED)
    assert int((sc > 0).sum()) > 0 or live == 0


def test_greedy_nms_dense_sorted_set(cuda):
    boxes, scores = dense_sorted_candidates(np.random.default_rng(1), 4, 16384,
                                            7200, 150)
    sc = assert_greedy_equal(cuda, boxes, scores, 0.6, 300,
                             nms_pallas.PATH_ORDERED)
    assert (sc > 0).sum(1).tolist() == [150] * 4  # one pick a cluster


def test_greedy_nms_paths_chosen_per_image(cuda):
    """One sorted and one unsorted image in a batch, and a sorted one whose
    max_det is above the ordered walk's cap."""
    rng = np.random.default_rng(2)
    sb, ss = sorted_candidates(rng, 1, 2048, 1500)
    ub, us = greedy_candidates(rng, 1, 2048)
    boxes, scores = torch.cat([sb, ub]).to(cuda), torch.cat([ss, us]).to(cuda)
    idx, sc = nms_pallas.greedy_nms_pallas(boxes, scores, 0.6, 300)
    want = nms_pallas.greedy_nms_plain(boxes, scores, 0.6, 300)
    torch.cuda.synchronize()
    assert torch.equal(idx, want[0]) and torch.equal(sc, want[1])
    assert nms_pallas.last_paths.tolist() == [nms_pallas.PATH_ORDERED,
                                              nms_pallas.PATH_ARGMAX]
    assert_greedy_equal(cuda, sb, ss, 0.6, nms_pallas.KEPT_CAP + 1,
                        nms_pallas.PATH_ARGMAX)


def test_greedy_nms_ordered_plain_on_the_card(cuda):
    """The plain form of the walk, on CUDA tensors, at the kernel's own
    round and survivor sizes."""
    boxes, scores = (t.to(cuda) for t in sorted_candidates(
        np.random.default_rng(3), 2, 4096, 3000, spread=1200.0))
    got = nms_pallas.greedy_nms_ordered_plain(boxes, scores, 0.6, 300)
    want = nms_pallas.greedy_nms_plain(boxes, scores, 0.6, 300)
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])


@pytest.mark.parametrize("c_hid,dtype", [(128, torch.float32),
                                         (128, torch.bfloat16),
                                         (256, torch.float32),
                                         (192, torch.float32),
                                         (192, torch.bfloat16),
                                         (256, torch.bfloat16)])
def test_seg_head_kernel_matches_plain(cuda, full_f32, c_hid, dtype):
    # the model family's: s (c_hid 128), m (192) and l (256)
    chans = (2 * c_hid, 2 * c_hid, 4 * c_hid)
    head = random_psp2_head(chans, c_hid).to(cuda)
    xs = [x.to(cuda, dtype) for x in psp2_inputs(2, 80, 80, chans)]
    before = seg_head_pallas.launches
    got = seg_head_pallas.fused_psp2_eval(xs, head, 3)
    assert seg_head_pallas.launches == before + 1
    want = seg_head_pallas.fused_psp2_eval_plain(xs, head, 3)
    torch.cuda.synchronize()
    assert got.shape == want.shape == (2, 80, 80, 3)
    check_psp2(got, want, dtype)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("hw,co,silu", [((640, 640), 32, True),
                                        ((640, 640), 64, True),
                                        ((640, 640), 24, False),
                                        ((100, 70), 16, True),  # ragged
                                        ((640, 640), 48, True),
                                        ((640, 640), 32, False),
                                        ((200, 328), 32, True),  # ragged
                                        ((200, 328), 64, False),
                                        ((2, 2), 8, True)])
def test_stem_kernel_matches_plain(cuda, full_f32, dtype, hw, co, silu):
    x, w6, bias = stem_inputs(2, *hw, co)
    x = x.to(cuda, dtype)
    wm = stem_pallas.stem_weight_matrix(w6, dtype).to(cuda)
    bias = torch.from_numpy(bias).to(cuda)
    before = stem_pallas.launches
    got = stem_pallas.stem_conv(x, wm, bias, silu=silu)
    assert stem_pallas.launches == before + 1
    want = stem_pallas.stem_conv_plain(x, wm, bias, silu)
    torch.cuda.synchronize()
    assert got.shape == (2, hw[0] // 2, hw[1] // 2, co)
    assert got.dtype == dtype
    assert stem_pallas.last_variant == stem_pallas.pick_variant(dtype) == (
        "mma" if dtype == torch.bfloat16 else "fma")
    check_close(got, want, f"K5 CO {co}", 1e-5)


@pytest.mark.parametrize("scale", [1.0, 8.0])
def test_stem_kernel_silu_tails(cuda, scale):
    """The tensor-core kernel's SiLU (tanh.approx) stays inside the bf16 bar
    on activations of order 1 and on ones that reach far into both tails."""
    x, w6, bias = stem_inputs(2, 200, 328, 32, seed=5)
    x = x.to(cuda, torch.bfloat16)
    wm = stem_pallas.stem_weight_matrix(w6 * scale, torch.bfloat16).to(cuda)
    bias = torch.from_numpy(bias).to(cuda)
    got = stem_pallas.stem_conv(x, wm, bias)
    want = stem_pallas.stem_conv_plain(x, wm, bias)
    torch.cuda.synchronize()
    assert stem_pallas.last_variant == "mma"
    check_close(got, want, f"K5 SiLU x{scale}", 1e-5)


def test_stem_kernel_follows_the_tap_matrix(cuda):
    """The kernel reads the tap matrix it is given on every call: one changed
    through ``.data``, which no version counter shows, gives the new
    result, and two stems used in turn give each its own."""
    x, w6, bias = stem_inputs(2, 64, 96, 32, seed=9)
    x = x.to(cuda, torch.bfloat16)
    wm = stem_pallas.stem_weight_matrix(w6, torch.bfloat16).to(cuda)
    other = stem_pallas.stem_weight_matrix(w6[..., ::-1].copy(),
                                           torch.bfloat16).to(cuda)
    bias = torch.from_numpy(bias).to(cuda)
    for step in range(3):
        for m in (wm, other):
            got = stem_pallas.stem_conv(x, m, bias)
            check_close(got, stem_pallas.stem_conv_plain(x, m, bias),
                        f"K5 step {step}", 1e-5)
        wm.data.mul_(-0.5)


# yolov5s_seg's eight C3 rows, then ragged maps (tiles cut by the border):
# small ones, row 4's widths on a map its 16 x 16 tile does not divide, rows
# 9/23's widths, channel counts that are no multiple of 64 (a warp pair
# splits 6 n8 tiles 4 + 2) and a c_ of 8, which the CUDA cores take
C3_CASES = [(row, c, c2, c_, n, sc, (side, side))
            for row, c, c2, c_, n, sc, side in C3_SERVED] + [
    (0, 32, 32, 16, 3, True, (12, 20)), (1, 128, 64, 32, 2, False, (7, 9)),
    (30, 128, 128, 64, 3, True, (45, 37)), (31, 512, 512, 256, 1, False,
                                            (23, 17)),
    (32, 96, 48, 48, 2, True, (11, 13)), (33, 16, 16, 8, 1, True, (9, 9))]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("row,c,c2,c_,n,shortcut,hw", C3_CASES)
def test_c3_kernel_matches_plain(cuda, full_f32, dtype, row, c, c2, c_, n,
                                 shortcut, hw):
    rng = np.random.default_rng(row)
    params = c3_fused.c3_params(random_c3_params(rng, c, c_, c2, n), cuda,
                                dtype)
    x = torch.from_numpy(rng.normal(size=(2, *hw, c)).astype(
        np.float32)).to(cuda, dtype)
    before = c3_fused.launches
    got = c3_fused.c3_fused(x, params, n, shortcut)
    assert c3_fused.launches == before + 1
    want = c3_fused.c3_plain(x, params, n, shortcut)
    torch.cuda.synchronize()
    assert got.shape == (2, *hw, c2) and got.dtype == dtype
    assert c3_fused.last_variant == c3_fused.pick_variant(dtype, c, c_, c2)
    assert c3_fused.last_variant == (
        "mma" if dtype == torch.bfloat16 and c_ % 16 == 0 else "fma")
    check_close(got, want, f"K6 row {row}", 1e-4)


@pytest.mark.parametrize("m,k,n", [(1000, 512, 256), (128, 16, 64),
                                   (77, 48, 64), (300, 160, 128)])
def test_shared_mma_tile_matches_matmul(cuda, m, k, n):
    rng = np.random.default_rng(m)
    a = torch.from_numpy(rng.normal(size=(m, k)).astype(np.float32)).to(
        cuda, torch.bfloat16)
    w = torch.from_numpy((rng.normal(size=(k, n)) / k ** 0.5).astype(
        np.float32)).to(cuda, torch.bfloat16)
    before = seg_head_pallas.conv_variants["mma"]
    got = seg_head_pallas.conv1x1_f32(a, w)
    assert seg_head_pallas.conv_variants["mma"] == before + 1
    want = torch.matmul(a.float(), w.float())
    torch.cuda.synchronize()
    torch.testing.assert_close(got, want, rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("hw", [(80, 80), (36, 28)])
def test_seg_head_tensor_core_convs(cuda, hw):
    chans = (256, 256, 512)  # yolov5s_seg, c_hid 128
    head = random_psp2_head(chans, 128).to(cuda)
    xs = [x.to(cuda, torch.bfloat16) for x in psp2_inputs(3, *hw, chans)]
    before = dict(seg_head_pallas.conv_variants)
    got = seg_head_pallas.fused_psp2_eval(xs, head, 3)
    took = {k: v - before[k] for k, v in seg_head_pallas.conv_variants.items()}
    assert took == {"mma": 7, "narrow": 2, "fma": 0}
    want = seg_head_pallas.fused_psp2_eval_plain(xs, head, 3)
    torch.cuda.synchronize()
    assert got.shape == want.shape == (3, *hw, 3)
    check_psp2(got, want, torch.bfloat16)


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
@pytest.mark.parametrize("fused", [True, False])
def test_train_step_matches_cpu(cuda, dtype, fused):
    with no_tf32():
        res = train_parity(torch.device("cuda"), fused, dtype)
    check_train_parity(res, dtype, f"fused {fused}, {dtype}")


@pytest.mark.parametrize("members,augment", [(1, False), (1, True),
                                             (2, True)])
def test_detect_program_matches_cpu(cuda, full_f32, members, augment):
    """cli.detect's device program (forward, K1 at max_det 1000 with a
    class filter, K2 on the 1/8 logits: f32 means of the members where
    there are two) on the card against the CPU, tiny model at 64 px in
    f32: the same detection counts and classes, boxes within 1e-4 of the
    largest coordinate (random weights give boxes of some 800 px) and
    scores within 1e-4 (TTA's resizes and its division by 0.83 and 0.67
    carry the two devices' f32 sums to 1.2e-5 of the largest coordinate
    and 2.3e-5 in a score), seg maps equal on 99.9% of pixels."""
    from desenet_tpu_torch.cli.detect import detect_program
    from desenet_tpu_torch.eval.ensemble import EnsembleModel
    from desenet_tpu_torch.testing import calibrated_tiny

    models = [calibrated_tiny(s, seg_upsample=False, fuse_focus=True)
              for s in range(members)]
    cpu = EnsembleModel(models) if members > 1 else models[0]
    img = torch.randint(0, 256, (3, 64, 64, 3), dtype=torch.uint8,
                        generator=torch.Generator().manual_seed(1))
    want = detect_program(cpu, img, 0.005, classes=(0, 2), augment=augment)
    k1, k2 = nms_fused.launches, seg_pallas.launches
    got = detect_program(cpu.to(cuda), img.to(cuda), 0.005, classes=(0, 2),
                         augment=augment)
    assert (nms_fused.launches - k1, seg_pallas.launches - k2) == (1, 1)
    (gn, gseg), (wn, wseg) = got, want
    assert torch.equal(gn.num.cpu(), wn.num) and int(wn.num.sum()) > 0
    assert torch.equal(gn.classes.cpu(), wn.classes)
    assert (gn.boxes.cpu() - wn.boxes).abs().max() <= \
        1e-4 * wn.boxes.abs().max()
    assert (gn.scores.cpu() - wn.scores).abs().max() <= 1e-4
    assert (gseg.cpu() == wseg).float().mean() >= 0.999


@pytest.mark.parametrize("case", INT8_CONV_CASES + INT8_GROUPED_CASES,
                         ids=lambda c: c[0])
def test_int8_conv_matches_plain(cuda, case):
    """The int8 conv kernel against its plain version on the card: the
    int32 sums over all parts bit-equal (OUT_I32), the block's outputs at
    ``testing.check_int8``'s bar (int8 within 1 LSB, equal on 99.9%)."""
    c = int8_conv_case(case, cuda)
    parts, prep = c["parts"], c["prep"]
    before = int8_conv.launches
    raw = int8_conv.run(parts, prep, out_mode=int8_conv.OUT_I32)
    raw_plain = int8_conv.int8_conv_plain(parts, prep,
                                          out_mode=int8_conv.OUT_I32)
    args = dict(residual=c["residual"], res_scale=c["res_scale"],
                out_scale=c["out_scale"], act=c["act"],
                out_mode=c["out_mode"])
    got = int8_conv.run(parts, prep, **args)
    want = int8_conv.int8_conv_plain(parts, prep, **args)
    assert int8_conv.launches == before + 2
    torch.cuda.synchronize()
    assert torch.equal(raw, raw_plain)
    assert got.dtype == want.dtype and got.shape == want.shape
    check_int8(got, want, case[0])


def test_int8_conv_grouped_takes_one_part(cuda):
    """A grouped conv's parts are concatenated first (as the JAX package's
    ``int8_conv_block`` sees them): the kernel takes one."""
    c = int8_conv_case(INT8_GROUPED_CASES[0], cuda)
    with pytest.raises(ValueError, match="one for a grouped conv"):
        int8_conv.run(c["parts"] * 2, c["prep"])


# ---- the phase pass (csrc/conv_epilogue.cu desenet_conv_epilogue_phases) ---


@pytest.mark.parametrize("case", PHASE_CASES,
                         ids=lambda c: "x".join(map(str, c)))
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_phase_kernel_matches_plain(cuda, case, dtype):
    """The plain version's arithmetic op for op, so bit for bit: on the
    16-byte groups (C 64; C 20 in f32) and one element a thread (C 3; C 20
    in bf16)."""
    y, scale, shift = (t.to(cuda) for t in phases_case(case, dtype))
    before = conv_epilogue.phase_launches
    got = conv_epilogue.conv_epilogue_phases(y, scale, shift)
    want = conv_epilogue.conv_epilogue_phases_plain(y, scale, shift)
    torch.cuda.synchronize()
    assert conv_epilogue.phase_launches == before + 1
    b, c, h, w = case
    assert got.shape == (b, c, 2 * h, 2 * w) and got.dtype == dtype
    assert got.is_contiguous(memory_format=torch.channels_last)
    assert torch.equal(got, want)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_phase_kernel_misaligned_takes_one_element(cuda, dtype):
    """A y one element off 16-byte alignment: one element a thread, still
    bit for bit."""
    y0, scale, shift = (t.to(cuda) for t in phases_case(PHASE_CASES[0],
                                                        dtype, seed=1))
    n, c4, h1, w1 = y0.shape
    buf = torch.empty(y0.numel() + 1, dtype=dtype, device=cuda)
    y = torch.as_strided(buf, y0.shape, (h1 * w1 * c4, 1, w1 * c4, c4),
                         storage_offset=1)
    y.copy_(y0)
    assert y.is_contiguous(memory_format=torch.channels_last)
    assert y.data_ptr() % 16 != 0
    got = conv_epilogue.conv_epilogue_phases(y, scale, shift)
    assert torch.equal(got, conv_epilogue.conv_epilogue_phases_plain(
        y0, scale, shift))


@pytest.mark.parametrize("what,says", PHASE_REFUSALS)
def test_phase_kernel_refusals_raise(cuda, what, says):
    """A card tensor the phase kernel cannot take is a ValueError that
    names why, never the plain version, and launches nothing."""
    y, scale, shift = (t.to(cuda) if isinstance(t, torch.Tensor) else t
                       for t in phases_refusal_case(what))
    before = conv_epilogue.phase_launches
    with pytest.raises(ValueError, match=says):
        conv_epilogue.conv_epilogue_phases(y, scale, shift)
    assert conv_epilogue.phase_launches == before


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_phased_proto_on_the_card(cuda, full_f32, dtype):
    """Proto at the x7seg cell's widths on a b2 P3 map, channels_last:
    the phase path (the folded conv and the phase kernel) against the
    upsample and 3x3 conv with the one-pass epilogue (``check_close``:
    bf16 at ``BF16_BAR``, f32 with TF32 off at rtol/atol 1e-4)."""
    from desenet_tpu_torch.models.heads import Proto
    from desenet_tpu_torch.testing import randomize_bn

    c1, c_, c2, hw = PROTO_SERVED
    torch.manual_seed(0)
    proto = randomize_bn(Proto(c1, c_, c2), seed=0).eval().to(
        cuda, dtype, memory_format=torch.channels_last)
    g = torch.Generator().manual_seed(2)
    x = torch.randn((2, c1, hw, hw), generator=g).to(cuda, dtype).contiguous(
        memory_format=torch.channels_last)
    with torch.inference_mode():
        for cv in (proto.cv1, proto.cv2, proto.cv3):
            cv.fuse_epilogue()
        want = proto(x)
        proto.fuse_phases()
        before = conv_epilogue.phase_launches
        got = proto(x)
        torch.cuda.synchronize()
    assert conv_epilogue.phase_launches == before + 1
    check_close(got, want, "phased Proto", 1e-4)
