"""The CUDA kernels K1 (csrc/nms_fused.cu), K2 (csrc/seg_tail.cu), K3
(csrc/nms_greedy.cu) and K4 (csrc/seg_head_psp2.cu) against their plain
PyTorch versions, on the card. Each test skips without
a CUDA device (decided in the fixture, never at import). Run on the card:

    python -m pytest --noconftest tests/test_torch_kernels_cuda.py -q

(``--noconftest``: tests/conftest.py imports JAX, which the card's machine
need not have.)

K1-K3 do the plain versions' f32 arithmetic in the same order with no
fused multiply-adds, so the results must be equal. K4 sums its products in
another order than the plain version's matmuls: it is held to
``desenet_tpu_torch.testing.check_psp2``'s bars (f32 at rtol/atol 1e-4 with
TF32 off; bf16 within 1e-2 of the largest plain logit and class decisions
equal on at least 99% of positions). The inputs come from
``desenet_tpu_torch.testing``, as chip_smoke.py's do.
"""

import numpy as np
import pytest
import torch

from desenet_tpu_torch.ops import (nms_fused, nms_pallas, seg_head_pallas,
                                   seg_pallas)
from desenet_tpu_torch.testing import (check_psp2, greedy_candidates,
                                       psp2_inputs, random_psp2_head,
                                       synthetic_decode)

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


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


@pytest.mark.parametrize("c_hid,dtype", [(128, torch.float32),
                                         (128, torch.bfloat16),
                                         (256, torch.float32)])
def test_seg_head_kernel_matches_plain(cuda, c_hid, dtype):
    tf32 = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        chans = (2 * c_hid, 2 * c_hid, 4 * c_hid)  # the model family's
        head = random_psp2_head(chans, c_hid).to(cuda)
        xs = [x.to(cuda, dtype) for x in psp2_inputs(2, 80, 80, chans)]
        before = seg_head_pallas.launches
        got = seg_head_pallas.fused_psp2_eval(xs, head, 3)
        assert seg_head_pallas.launches == before + 1
        want = seg_head_pallas.fused_psp2_eval_plain(xs, head, 3)
        torch.cuda.synchronize()
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = tf32
    assert got.shape == want.shape == (2, 80, 80, 3)
    check_psp2(got, want, dtype)
