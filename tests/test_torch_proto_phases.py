"""Proto's phase path on the CPU (``models/heads.py`` Proto,
``ops/conv_epilogue.py``: ``fold_phases``, ``conv_epilogue_phases`` and its
plain version).

- The fold: the folded 2x2 conv over the small map, pad 1, read by phase,
  equals the 3x3 conv over its nearest 2x upsample in float64 within
  1e-12, for even and odd H and W and a width that is not a multiple of 8.
- The plain phase pass equals the one-pass epilogue's plain version on
  each phase, interleaved, bit for bit.
- A fused Proto (the plain phase pass) against its unfused forward: f32
  within 1e-4, float64 within 1e-12; the counters ``proto.phased`` and
  ``proto.plain`` say which path an eval call took, and the phase pass
  counts ``epilogue.fused`` as the pass it replaces did.
- ``.to()``, ``load_state_dict`` and ``train(True)`` drop the folded
  weight, and the upsample and 3x3 conv run again.
- What the phase kernel refuses, named (the card's ValueErrors:
  ``tests/test_torch_kernels_cuda.py``).
"""

import copy

import pytest
import torch
import torch.nn.functional as F

from desenet_tpu_torch.models.heads import Proto
from desenet_tpu_torch.ops import conv_epilogue as CE
from desenet_tpu_torch.ops.resize import upsample_nearest
from desenet_tpu_torch.testing import (PHASE_CASES, PHASE_REFUSALS,
                                       phases_case, phases_refusal_case,
                                       randomize_bn)
from desenet_tpu_torch.utils import profiling

PHASES = ((0, 0), (0, 1), (1, 0), (1, 1))  # (py, px) of phase p


@pytest.mark.parametrize("h,w,c", [(6, 8, 8), (5, 7, 5), (4, 3, 12)])
def test_fold_is_the_upsampled_conv_in_float64(h, w, c):
    g = torch.Generator().manual_seed(h * w)
    x = torch.randn((2, c, h, w), generator=g, dtype=torch.float64)
    wt = torch.randn((c + 1, c, 3, 3), generator=g, dtype=torch.float64)
    want = F.conv2d(upsample_nearest(x, 2), wt, padding=1)
    k = CE.fold_phases(wt)
    assert k.shape == (4 * (c + 1), c, 2, 2) and k.dtype == torch.float64
    y = F.conv2d(x, k, padding=1)
    assert y.shape == (2, 4 * (c + 1), h + 1, w + 1)
    for p, (py, px) in enumerate(PHASES):
        got = y[:, p * (c + 1):(p + 1) * (c + 1), py:py + h, px:px + w]
        assert float((got - want[:, :, py::2, px::2]).abs().max()) <= 1e-12


def test_fold_rounds_once_to_the_weights_dtype():
    g = torch.Generator().manual_seed(0)
    wt = torch.randn((4, 3, 3, 3), generator=g).to(torch.bfloat16)
    k = CE.fold_phases(wt)
    assert k.dtype == torch.bfloat16
    exact = CE.fold_phases(wt.double())
    assert torch.equal(k, exact.to(torch.bfloat16))


@pytest.mark.parametrize("case", PHASE_CASES,
                         ids=lambda c: "x".join(map(str, c)))
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_plain_phase_pass_is_the_epilogue_by_phase(case, dtype):
    y, scale, shift = phases_case(case, dtype)
    got = CE.conv_epilogue_phases_plain(y, scale, shift)
    b, c, h, w = case
    assert got.shape == (b, c, 2 * h, 2 * w) and got.dtype == dtype
    assert got.is_contiguous(memory_format=torch.channels_last)
    for p, (py, px) in enumerate(PHASES):
        ph = y[:, p * c:(p + 1) * c, py:py + h, px:px + w]
        assert torch.equal(got[:, :, py::2, px::2],
                           CE.conv_epilogue_plain(ph, scale, shift, True))


def _counted(fn):
    profiling.reset()
    profiling.set_tracing(True)
    try:
        out = fn()
        c = profiling.counters()
    finally:
        profiling.set_tracing(False)
        profiling.reset()
    return out, {k: c.get(k, 0) for k in (
        "proto.phased", "proto.plain", "epilogue.fused", "epilogue.plain")}


def _proto(dtype=torch.float32):
    torch.manual_seed(0)
    return randomize_bn(Proto(6, 12, 5), seed=1).eval().to(dtype)


def _fuse(proto):
    for cv in (proto.cv1, proto.cv2, proto.cv3):
        cv.fuse_epilogue()
    proto.fuse_phases()
    return proto


@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-4),
                                       (torch.float64, 1e-12)])
def test_fused_proto_matches_unfused(dtype, tol):
    proto = _proto(dtype)
    x = torch.randn((2, 6, 7, 5), generator=torch.Generator().manual_seed(2),
                    dtype=dtype)
    with torch.no_grad():
        want, n_want = _counted(lambda: proto(x))
        fused = _fuse(copy.deepcopy(proto))
        assert "phases" in fused.cv2._derived
        got, n_got = _counted(lambda: fused(x))
    assert n_want == {"proto.phased": 0, "proto.plain": 1,
                      "epilogue.fused": 0, "epilogue.plain": 3}
    # cv1, the phase pass in cv2's place, cv3
    assert n_got == {"proto.phased": 1, "proto.plain": 0,
                     "epilogue.fused": 3, "epilogue.plain": 0}
    assert got.shape == want.shape == (2, 5, 14, 10)
    torch.testing.assert_close(got, want, rtol=tol, atol=tol)


def test_grad_or_training_takes_the_old_path():
    proto = _fuse(_proto())
    x = torch.randn((1, 6, 4, 4), generator=torch.Generator().manual_seed(3))
    _, n = _counted(lambda: proto(x))  # autograd on
    assert (n["proto.phased"], n["proto.plain"]) == (0, 1)
    proto.train()
    _, n = _counted(lambda: proto(x))
    assert (n["proto.phased"], n["proto.plain"]) == (0, 0)


@pytest.mark.parametrize("how", ["to", "load_state_dict", "train"])
def test_moving_reloading_or_training_drops_the_fold(how):
    proto = _fuse(_proto(torch.float64))
    unfused = _proto(torch.float64)
    x = torch.randn((2, 6, 5, 6), generator=torch.Generator().manual_seed(4),
                    dtype=torch.float64)
    if how == "to":
        proto.to(torch.float64)
    elif how == "load_state_dict":
        proto.load_state_dict(copy.deepcopy(proto.state_dict()))
    else:
        proto.train()
        proto.eval()
    assert "phases" not in proto.cv2._derived
    with torch.no_grad():
        got, n = _counted(lambda: proto(x))
        want = unfused(x)
    assert (n["proto.phased"], n["proto.plain"]) == (0, 1)
    assert torch.equal(got, want)


@pytest.mark.parametrize("what,says", PHASE_REFUSALS + [("none", None)])
def test_phase_refusal_names_what_the_kernel_cannot_take(what, says):
    why = CE._phases_refusal(*phases_refusal_case(what))
    if says is None:
        assert why is None
    else:
        assert says in why


def test_cpu_phase_pass_is_the_plain_version_and_counts():
    y, scale, shift = phases_case(PHASE_CASES[1], torch.float32)
    before = CE.phase_launches
    got, n = _counted(lambda: CE.conv_epilogue_phases(y, scale, shift))
    assert CE.phase_launches == before
    assert n["epilogue.fused"] == 1
    assert torch.equal(got, CE.conv_epilogue_phases_plain(y, scale, shift))
