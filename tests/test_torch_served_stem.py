"""The served stem (``ops/stem_pallas.served_stem``, the third kernel of
``csrc/stem_conv.cu``): row 0 of a ``fuse()``'d bf16 model on the uint8
batch as uploaded, widened, conv, eval BN and SiLU in one pass.

On the CPU, where the plain version runs:

- (a) ``served_stem_plain`` (u8 widen, f32 sums, affine, SiLU, one
  rounding) against ``stem_conv_reference`` on the widened image with the
  BN applied, CO 32, 48, 64 and 80, an odd batch, a map the kernel's tile
  does not divide; ``widen_u8`` is the f32 reciprocal multiply;
- a fused tiny model on the uint8 image against the same model on the
  widened one, within the fused epilogue's bar of
  ``tests/test_torch_conv_epilogue.py`` (2^-5 of the largest output);
- (c) the counters: an eval forward on a uint8 image counts ``stem.fused``
  (and ``epilogue.fused`` for the stem), one on a float image
  ``stem.plain``, a training forward neither; a CPU ``Predictor`` widens
  on the host side of the model and counts ``stem.plain``;
- every condition that keeps a uint8 image from row 0 is a ValueError
  that names it.

On a card (marked ``cuda``, skipped without one; decided in the fixture):
(b) the kernel's widen bit-identical to ``img.to(bf16) / 255`` for all 256
byte values; the kernel against its plain version (``BF16_BAR``) and
against the parent's path, cuDNN's conv then ``conv_epilogue``
(``BF16_MODULE_BAR``), at the s, l and x6 stem shapes (a smaller batch)
and on ragged maps, a W that is no multiple of 16 (byte loads), CO in
one, two and three wgmma widths (each of 64, 32, 16 and 8), the SiLU off
(the tiny graph's CO 8 in the Predictor case); a whole tiny
``Predictor``, fused against its model on the widened batch; a uint8 image
on a path that cannot take it raises and launches nothing. Run there:

    python -m pytest --noconftest tests/test_torch_served_stem.py -q
"""

import numpy as np
import pytest
import torch
import torch.nn.functional as F

from desenet_tpu_torch.api import Predictor
from desenet_tpu_torch.models import build_model
from desenet_tpu_torch.ops import conv_epilogue as CE
from desenet_tpu_torch.ops import stem_pallas as S
from desenet_tpu_torch.testing import (BF16_BAR, BF16_MODULE_BAR,
                                       boosted_state, check_bf16,
                                       randomize_bn, tiny_cfg)
from desenet_tpu_torch.utils import profiling

CL = torch.channels_last
IMGSZ = 64


def _image(b, h, w, seed=0):
    return torch.from_numpy(np.random.default_rng(seed).integers(
        0, 256, (b, h, w, 3), dtype=np.uint8))


def _stem_case(co, seed=0):
    """A bf16 (CO, 3, 6, 6) conv weight, its tap matrix and a BN affine."""
    g = torch.Generator().manual_seed(seed)
    w = (torch.randn((co, 3, 6, 6), generator=g) * 0.1).bfloat16()
    scale = torch.rand(co, generator=g) + 0.5
    shift = torch.randn(co, generator=g) * 0.3
    wm = S.stem_weight_matrix(w.float().permute(2, 3, 1, 0).numpy(),
                              torch.bfloat16)
    return w, wm, scale, shift


def _reference(x, w, scale, shift, silu):
    """``stem_conv_reference``'s f32 conv of the widened image, then the
    affine and the SiLU in f32, rounded once."""
    y = S.stem_conv_reference(S.widen_u8(x).float(),
                              w.float().permute(2, 3, 1, 0).numpy(),
                              silu=False)
    v = y * scale + shift
    return (F.silu(v) if silu else v).bfloat16()


def _counted(fn):
    """``fn()``'s result and the stem and epilogue counters it added."""
    profiling.reset()
    profiling.set_tracing(True)
    try:
        out = fn()
    finally:
        profiling.set_tracing(False)
    c = profiling.counters()
    profiling.reset()
    return out, tuple(c.get(k, 0) for k in ("stem.fused", "stem.plain",
                                            "epilogue.fused",
                                            "epilogue.plain"))


@pytest.mark.parametrize("silu", [True, False])
@pytest.mark.parametrize("co", [32, 48, 64, 80])
def test_plain_matches_the_reference(co, silu):
    x = _image(3, 40, 72, seed=co)
    w, wm, scale, shift = _stem_case(co, seed=co)
    got = S.served_stem_plain(x, wm, scale, shift, silu)
    want = _reference(x, w, scale, shift, silu)
    assert got.dtype == torch.bfloat16 and got.shape == (3, 20, 36, co)
    check_bf16(got, want, f"served stem plain CO {co}")
    # the sums differ in order only: nearly every value rounds alike
    assert float((got == want).float().mean()) > 0.99


def test_widen_is_the_f32_reciprocal_multiply():
    x = torch.arange(256).to(torch.uint8)
    want = torch.from_numpy(np.arange(256, dtype=np.float32)
                            * (np.float32(1) / np.float32(255)))
    assert torch.equal(S.widen_u8(x), want.bfloat16())


def _tiny(dtype=torch.bfloat16, fuse=True, **kw):
    torch.set_num_threads(2)
    model, _ = build_model(tiny_cfg(), seg_upsample=False, **kw)
    randomize_bn(model, seed=0)
    model = model.to(dtype, memory_format=CL).eval()
    return model.fuse() if fuse else model


def _widened(x):
    """``infer``'s widen of the (B, 3, H, W) uint8 view."""
    return x.to(torch.bfloat16).contiguous(memory_format=CL) / 255


def _outputs(out):
    (dec, _), seg = out
    return dec, seg


def _held(got, want):
    for g, w in zip(got, want):
        assert g.dtype == w.dtype
        scale = w.float().abs().max().item()
        assert (g.float() - w.float()).abs().max().item() <= 2 ** -5 * scale


def test_fused_model_on_the_uint8_image_matches_the_widened_one():
    model = _tiny(fuse_focus=True)
    x = _image(3, IMGSZ, IMGSZ, seed=1).permute(0, 3, 1, 2)
    with torch.inference_mode():
        assert model.uint8_refusal(x) is None
        got = _outputs(model(x))
        want = _outputs(model(_widened(x)))
    _held(got, want)


def test_counters_say_which_stem_ran():
    model = _tiny(fuse_focus=True)
    x = _image(2, IMGSZ, IMGSZ, seed=2).permute(0, 3, 1, 2)
    with torch.inference_mode():
        _, fused = _counted(lambda: model(x))
        _, plain = _counted(lambda: model(_widened(x)))
    # the stem's conv epilogue runs inside the served stem: still 70 fused
    assert fused == (1, 0, 70, 2)
    assert plain == (0, 1, 70, 2)
    model.train()
    _, train = _counted(lambda: model(_widened(x)))
    assert train[:2] == (0, 0)


def test_cpu_predictor_widens_and_counts_the_plain_stem():
    model, _ = build_model(tiny_cfg())
    pred = Predictor(tiny_cfg(), boosted_state(model, 0), imgsz=IMGSZ,
                     device="cpu", conf_thres=1e-3)
    _, counts = _counted(lambda: pred.run_batch(
        _image(2, IMGSZ, IMGSZ, seed=3).numpy()))
    assert counts[:2] == (0, 1)


def _refusal_case(what):
    """A tiny model and a uint8 image that it cannot take for ``what``."""
    x = _image(1, IMGSZ, IMGSZ).permute(0, 3, 1, 2)
    kw = {"fuse_focus": what != "focus"}
    if what == "s2d":
        kw["stem_s2d"] = True
    model = _tiny(dtype=torch.float32 if what == "float32" else
                  torch.bfloat16, fuse=what != "unfused", **kw)
    if what == "moved":
        model = model.to(torch.bfloat16)
    elif what == "train":
        model.train()
    elif what == "odd":
        x = _image(1, IMGSZ, IMGSZ - 2)[:, :, :-1].permute(0, 3, 1, 2)
    return model, x


@pytest.mark.parametrize("what,says", [
    ("unfused", "no fuse()"), ("moved", "dropped"), ("train", "training"),
    ("grad", "autograd"), ("float32", "not bfloat16"),
    ("odd", "H and W even"), ("focus", "row 0 is Focus"),
    ("s2d", "stem_s2d")])
def test_uint8_image_where_row_0_cannot_take_it_raises(what, says):
    model, x = _refusal_case(what)
    if what == "grad":
        why = model.uint8_refusal(x)
    else:
        with torch.inference_mode():
            why = model.uint8_refusal(x)
    assert says in why
    with pytest.raises(ValueError, match="served stem"), \
            torch.inference_mode(what != "grad"):
        model(x)


def test_served_stem_refuses_what_it_cannot_take():
    _, wm, scale, shift = _stem_case(32)
    x = _image(1, 8, 8)
    for bad in ((x.float(), wm, scale, shift), (x[:, :, :7], wm, scale, shift),
                (x, wm.float(), scale, shift), (x, wm[:, :31], scale, shift),
                (x, wm, scale.double(), shift)):
        with pytest.raises(ValueError, match="served_stem"):
            S.served_stem(*bad)


# ---- the kernel on a card ---------------------------------------------------


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


@pytest.mark.cuda
def test_kernel_widen_is_bit_identical(cuda):
    """A tap matrix that passes input (2 oy, 2 ox, c) to channel c: the
    output is the widened image itself, 256 byte values in each channel."""
    v = (torch.arange(256).view(16, 16, 1) + 85 * torch.arange(3)) % 256
    x = torch.zeros((1, 32, 32, 3), dtype=torch.uint8)
    x[0, ::2, ::2] = v.to(torch.uint8)
    wm = torch.zeros((S.K_PAD, 8), dtype=torch.bfloat16)
    for c in range(3):  # tap (ky, kx) = (2, 2): kk = (1 * 3 + 1) * 12 + c
        wm[48 + c, c] = 1
    xc = x.to(cuda)
    got = S.served_stem(xc, wm.to(cuda), torch.ones(8, device=cuda),
                        torch.zeros(8, device=cuda), silu=False)
    want = xc.to(torch.bfloat16) / 255
    assert torch.equal(got[..., :3], want[:, ::2, ::2])
    assert torch.equal(got[..., :3].cpu(), S.widen_u8(x)[:, ::2, ::2])
    assert not got[..., 3:].any()


def _parent_path(x, w, scale, shift, silu):
    """The served program before: widen, cuDNN's conv, ``conv_epilogue``."""
    xf = x.permute(0, 3, 1, 2).to(torch.bfloat16).contiguous(
        memory_format=CL) / 255
    y = F.conv2d(xf, w.contiguous(memory_format=CL), stride=2, padding=2)
    return CE.conv_epilogue(y.contiguous(memory_format=CL), scale, shift,
                            silu).permute(0, 2, 3, 1)


@pytest.mark.cuda
@pytest.mark.parametrize("b,h,w,co,silu", [
    (2, 640, 640, 32, True),    # s's stem: one width, 32
    (2, 640, 640, 64, True),    # l's: 64
    (1, 1280, 1280, 80, True),  # x6's: 64 + 16
    (3, 200, 328, 48, True),    # 32 + 16; W % 16 == 8: byte loads; ragged
    (1, 96, 64, 40, False),     # 32 + 8, no SiLU
    (1, 64, 96, 56, True),      # 32 + 16 + 8
])
def test_kernel_matches_plain_and_the_parent_path(cuda, b, h, w, co, silu):
    x = _image(b, h, w, seed=co).to(cuda)
    wt, wm, scale, shift = (t.to(cuda) for t in _stem_case(co, seed=h))
    with torch.inference_mode():
        before = S.served_launches
        got = S.served_stem(x, wm, scale, shift, silu=silu)
        torch.cuda.synchronize()
        assert S.served_launches == before + 1
        check_bf16(got, S.served_stem_plain(x, wm, scale, shift, silu),
                   f"served stem {(b, h, w, co)} vs plain", BF16_BAR)
        check_bf16(got, _parent_path(x, wt, scale, shift, silu),
                   f"served stem {(b, h, w, co)} vs the parent's path",
                   BF16_MODULE_BAR)


@pytest.mark.cuda
def test_predictor_takes_the_uint8_batch(cuda):
    model, _ = build_model(tiny_cfg())
    pred = Predictor(tiny_cfg(), boosted_state(model, 0), imgsz=IMGSZ,
                     device="cuda", conf_thres=1e-3)
    x = _image(4, IMGSZ, IMGSZ, seed=5).to(cuda)
    xv = x.permute(0, 3, 1, 2)
    with torch.inference_mode():
        assert pred.model.uint8_refusal(xv) is None
        before = S.served_launches
        got = _outputs(pred.model(xv))
        want = _outputs(pred.model(_widened(xv)))
        torch.cuda.synchronize()
    assert S.served_launches == before + 1
    _held(got, want)
    _, counts = _counted(lambda: pred.run_batch(x.cpu().numpy()))
    assert counts == (1, 0, 70, 2)
    assert S.served_launches == before + 2


@pytest.mark.cuda
@pytest.mark.parametrize("what", ["unfused", "float32", "focus"])
def test_uint8_on_the_card_where_row_0_cannot_take_it_raises(cuda, what):
    model, x = _refusal_case(what)
    model, x = model.to(cuda), x.to(cuda)
    if what != "unfused":
        model.fuse()  # .to() dropped the constants
    before = S.served_launches
    with torch.inference_mode(), pytest.raises(ValueError,
                                               match="served stem"):
        model(x)
    assert S.served_launches == before
