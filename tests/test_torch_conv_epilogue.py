"""The served ConvBnAct's fused epilogue (``DeSeNet.fuse``,
``ops/conv_epilogue.py``, ``csrc/conv_epilogue.cu``).

On the CPU, where the plain version runs:

- a ``fuse()``'d model against the same model unfused: float64 to 1e-12
  of the largest output, float32 at rtol/atol 1e-4 (TF32 off), on the tiny
  configs (the standard stem and ``stem_s2d``) and on full-width
  ``yolov5s_seg``, ``yolov5l_seg`` and ``yolov5x6_seg`` at a small image
  size; the counters ``epilogue.fused`` and ``epilogue.plain`` say which
  calls took the fused pass (at full width every call but the seg head's
  two 1x1 maps);
- the 1x1-map trap: a conv on a 1x1 map keeps its BN skipped and is
  counted plain; the plain version against BN, SiLU and add one at a time;
- a shortcut Bottleneck's fused cv2 equals ``y + x``;
- with grad enabled a fused model runs the separate ops;
- ``train()``, ``.to()`` and ``load_state_dict`` each drop the constants,
  and the model runs the separate ops again; the state dict is unchanged
  by ``fuse()``; a CPU ``Predictor`` is not fused.

On a card (marked ``cuda``, skipped without one): the kernel against the
plain version in bf16 and f32, with C a multiple of the vector width and
not, an odd pixel count, with and without a residual and the SiLU; a
storage offset that breaks 16-byte alignment takes the scalar kernel; a
tensor not contiguous in channels_last is a ValueError (the conditions
that raise are held on the CPU through ``_refusal``); bf16 agrees to 1 ulp
of the largest term of the sum. Run there:

    python -m pytest --noconftest tests/test_torch_conv_epilogue.py -q -m cuda
"""

import copy
import os

import numpy as np
import pytest
import torch

from desenet_tpu_torch.models import build_model, config_path
from desenet_tpu_torch.models.layers import Bottleneck, ConvBnAct
from desenet_tpu_torch.ops import conv_epilogue as CE
from desenet_tpu_torch.testing import (check_epilogue, no_tf32, randomize_bn,
                                       tiny_cfg)
from desenet_tpu_torch.utils import profiling

HERE = os.path.dirname(os.path.abspath(__file__))

# (config, image size, stem_s2d); the full-width models at a size the CPU
# runs in a second
MODELS = [("tiny_psp2", 64, False), ("tiny_psp2", 64, True),
          ("tiny_psp", 64, False), ("tiny_lab", 64, False),
          ("tiny_base", 64, False), ("yolov5s_seg", 64, False),
          ("yolov5l_seg", 64, False), ("yolov5x6_seg", 128, False)]
FULL = {"yolov5s_seg", "yolov5l_seg", "yolov5x6_seg"}


def _cfg(name):
    if name == "tiny_psp2":
        return tiny_cfg()
    if name in FULL:
        return config_path(name)
    yaml = pytest.importorskip("yaml")
    with open(os.path.join(HERE, "configs", f"{name}.yaml")) as fh:
        return yaml.safe_load(fh)


def _image(size, stem_s2d, dtype):
    x = torch.rand((2, 3, size, size),
                   generator=torch.Generator().manual_seed(1))
    if stem_s2d:
        from desenet_tpu_torch.ops.s2d import space_to_depth4

        x = space_to_depth4(x.permute(0, 2, 3, 1)).permute(0, 3, 1, 2)
    return x.to(dtype)


def _outputs(out):
    """The model's decoded detections and seg logits."""
    (dec, _), seg = out
    return dec, seg


def _counted(fn):
    """``fn()``'s result and the epilogue counters it added."""
    profiling.reset()
    profiling.set_tracing(True)
    try:
        out = fn()
    finally:
        profiling.set_tracing(False)
    c = profiling.counters()
    profiling.reset()
    return out, (c.get("epilogue.fused", 0), c.get("epilogue.plain", 0))


def _fused_consts(model):
    return [m for m in model.modules()
            if isinstance(m, ConvBnAct) and "epilogue" in m._derived]


def _convbnacts(model):
    return [m for m in model.modules() if isinstance(m, ConvBnAct)]


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
@pytest.mark.parametrize("name,size,stem_s2d", MODELS)
def test_fused_model_matches_unfused(name, size, stem_s2d, dtype):
    torch.set_num_threads(2)
    model, _ = build_model(_cfg(name), seg_upsample=False, fuse_focus=True,
                           stem_s2d=stem_s2d)
    randomize_bn(model, seed=0)
    model = model.to(dtype)
    x = _image(size, stem_s2d, dtype)
    with torch.no_grad(), no_tf32():
        want, (f0, p0) = _counted(lambda: _outputs(model(x)))
        assert f0 == 0 and p0 > 0
        model.fuse()
        assert len(_fused_consts(model)) == len(_convbnacts(model))
        got, (f1, p1) = _counted(lambda: _outputs(model(x)))
    assert f1 + p1 == p0
    assert f1 > 0
    if name in FULL:  # the seg head's 1x1 maps: PyramidPooling's bin 1
        assert p1 == 2  # and ACSP's global branch
    for g, w in zip(got, want):
        assert g.dtype == w.dtype
        if dtype == torch.float64:
            scale = w.abs().max().item()
            assert (g - w).abs().max().item() <= 1e-12 * scale
        else:
            torch.testing.assert_close(g, w, rtol=1e-4, atol=1e-4)


def _convbnact(c1, c2, k, act, seed=0):
    m = ConvBnAct(c1, c2, k, act=act)
    randomize_bn(m, seed)
    return m.eval().double()


@pytest.mark.parametrize("act", [True, False])
@pytest.mark.parametrize("hw", [(1, 1), (3, 5)])
def test_convbnact_fused_call_and_the_one_by_one_trap(hw, act):
    m = _convbnact(8, 12, 1, act)
    x = torch.randn((2, 8) + hw, generator=torch.Generator().manual_seed(2),
                    dtype=torch.float64)
    with torch.no_grad():
        want = m(x)
        m.fuse_epilogue()
        got, (fused, plain) = _counted(lambda: m(x))
    on_map = hw[0] * hw[1] > 1
    assert (fused, plain) == ((1, 0) if on_map else (0, 1))
    if not on_map:  # BN skipped: the conv and the activation alone
        ref = m.conv(x)
        assert torch.equal(got, torch.nn.functional.silu(ref) if act
                           else ref)
    torch.testing.assert_close(got, want, rtol=1e-12, atol=1e-12)


@pytest.mark.parametrize("residual", [False, True])
@pytest.mark.parametrize("act", [True, False])
def test_plain_version_is_bn_act_and_add(act, residual):
    g = torch.Generator().manual_seed(3)
    y = torch.randn((3, 6, 5, 7), generator=g, dtype=torch.float64)
    r = torch.randn(y.shape, generator=g, dtype=torch.float64)
    bn = torch.nn.BatchNorm2d(6, eps=1e-3).double().eval()
    randomize_bn(bn, 4)
    scale = bn.weight.detach() / torch.sqrt(bn.running_var + 1e-3)
    shift = bn.bias.detach() - bn.running_mean * scale
    want = bn(y)
    want = torch.nn.functional.silu(want) if act else want
    want = want + r if residual else want
    before = CE.launches
    got, (fused, plain) = _counted(lambda: CE.conv_epilogue(
        y, scale, shift, act, r if residual else None))
    assert CE.launches == before and (fused, plain) == (1, 0)
    assert got.data_ptr() != y.data_ptr()  # a new tensor on the CPU
    torch.testing.assert_close(got, want, rtol=1e-12, atol=1e-12)
    # f32 constants, bf16 in and out: computed in f32, rounded once
    yb, rb = y.bfloat16(), r.bfloat16()
    got = CE.conv_epilogue_plain(yb, scale.float(), shift.float(), act,
                                 rb if residual else None)
    v = yb.float() * scale.float().view(1, -1, 1, 1) + \
        shift.float().view(1, -1, 1, 1)
    v = torch.nn.functional.silu(v) if act else v
    v = v + rb.float() if residual else v
    assert got.dtype == torch.bfloat16 and torch.equal(got, v.bfloat16())


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
def test_shortcut_bottleneck_fused_equals_y_plus_x(dtype):
    b = Bottleneck(16, 16, shortcut=True)
    assert b.add
    randomize_bn(b, 5)
    b = b.eval().to(dtype)
    x = torch.randn((2, 16, 6, 6), generator=torch.Generator().manual_seed(6)
                    ).to(dtype)
    with torch.no_grad():
        want = b.cv2(b.cv1(x)) + x
        assert torch.equal(b(x), want)  # unfused: the add as before
        b.cv1.fuse_epilogue()
        b.cv2.fuse_epilogue()
        got, (fused, plain) = _counted(lambda: b(x))
    assert (fused, plain) == (2, 0)
    tol = 1e-12 if dtype == torch.float64 else 1e-5
    torch.testing.assert_close(got, want, rtol=tol, atol=tol)


def test_fused_model_with_autograd_runs_the_separate_ops():
    """With grad enabled a fused eval model runs BN, SiLU and add as
    before (the card's kernel writes in place), counted plain."""
    model = _tiny_fused()
    x = _image(64, False, torch.float64)
    got, (fused, plain) = _counted(lambda: _outputs(model(x)))
    assert (fused, plain) == (0, 72)
    assert got[1].requires_grad
    with torch.no_grad():
        nograd, (fused, plain) = _counted(lambda: _outputs(model(x)))
    assert fused == 70 and plain == 2
    for g, w in zip(got, nograd):
        torch.testing.assert_close(g.detach(), w, rtol=1e-12, atol=1e-12)


def _refusal_case(what):
    g = torch.Generator().manual_seed(7)
    y = torch.randn((2, 8, 3, 5), generator=g).contiguous(
        memory_format=torch.channels_last)
    scale, shift = torch.rand(8, generator=g), torch.randn(8, generator=g)
    res = None
    if what == "dtype":
        y = y.half()
    elif what == "layout":
        y = y.contiguous()
    elif what == "channels":
        y = torch.zeros((1, CE.MAX_C + 1, 2, 2)).contiguous(
            memory_format=torch.channels_last)
        scale = shift = torch.ones(CE.MAX_C + 1)
    elif what == "constants":
        scale = scale.double()
    elif what == "residual":
        res = y.contiguous()
    elif what == "autograd":
        y.requires_grad_(True)
    return y, scale, shift, res


@pytest.mark.parametrize("what,says", [
    ("dtype", "not bfloat16 or float32"), ("layout", "channels_last"),
    ("channels", f"more than {CE.MAX_C}"), ("constants", "scale is"),
    ("residual", "residual"), ("autograd", "autograd"), ("none", None)])
def test_refusal_names_what_the_kernel_cannot_take(what, says):
    """What ``conv_epilogue`` raises on a card tensor: each condition of
    the kernel named, and nothing for tensors it takes."""
    why = CE._refusal(*_refusal_case(what))
    if says is None:
        assert why is None
    else:
        assert says in why


def _tiny_fused():
    model, _ = build_model(tiny_cfg(), seg_upsample=False, fuse_focus=True)
    randomize_bn(model, seed=0)
    return model.double().fuse()


@pytest.mark.parametrize("how", ["train", "to", "load_state_dict"])
def test_moving_reloading_or_training_drops_the_constants(how):
    model = _tiny_fused()
    x = _image(64, False, torch.float64)
    unfused = copy.deepcopy(model)
    for m in _convbnacts(unfused):
        m.drop_derived_constants()
    assert len(_fused_consts(model)) == len(_convbnacts(model))
    if how == "train":
        model.train()
        assert not _fused_consts(model)
        model.eval()
    elif how == "to":
        model.to(torch.float64)
    else:
        model.load_state_dict(copy.deepcopy(model.state_dict()))
    assert not _fused_consts(model)
    with torch.no_grad():
        got, (fused, plain) = _counted(lambda: _outputs(model(x)))
        want = _outputs(unfused(x))
    assert fused == 0 and plain == 72
    for g, w in zip(got, want):
        assert torch.equal(g, w)


def test_fuse_leaves_the_state_dict_and_refuses_training_mode():
    model, _ = build_model(tiny_cfg(), seg_upsample=False, fuse_focus=True)
    randomize_bn(model, seed=0)
    before = {k: v.clone() for k, v in model.state_dict().items()}
    model.fuse()
    after = model.state_dict()
    assert list(after) == list(before)
    assert all(torch.equal(after[k], v) for k, v in before.items())
    model.train()
    with pytest.raises(ValueError, match="eval mode"):
        model.fuse()


def test_cpu_predictor_is_not_fused():
    from desenet_tpu_torch.api import Predictor
    from desenet_tpu_torch.models import init_weights

    torch.set_num_threads(2)
    model, _ = build_model(tiny_cfg(), fuse_focus=True)
    init_weights(model, torch.Generator().manual_seed(0))
    randomize_bn(model, seed=0)
    sd = model.state_dict()
    pred = Predictor(tiny_cfg(), sd, imgsz=64, half=False, device="cpu",
                     conf_thres=0.001)
    assert not _fused_consts(pred.model)
    batch = np.random.default_rng(0).integers(0, 256, (2, 64, 64, 3),
                                              dtype=np.uint8)
    got, (fused, plain) = _counted(lambda: pred.run_batch(batch))
    assert fused == 0 and plain == 72
    ref = Predictor(tiny_cfg(), sd, imgsz=64, half=False, device="cpu",
                    conf_thres=0.001)
    for g, w in zip(got, ref.run_batch(batch)):
        np.testing.assert_array_equal(g, w)


# ---- the kernel on a card ---------------------------------------------------


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _check_kernel(got, y, scale, shift, act, residual):
    check_epilogue(got, y, scale, shift, act, residual, "conv_epilogue")


def _case(cuda, shape, dtype, seed=0):
    g = torch.Generator().manual_seed(seed)
    n, c, h, w = shape
    y = (torch.randn(shape, generator=g) * 2).to(cuda, dtype).contiguous(
        memory_format=torch.channels_last)
    r = torch.randn(shape, generator=g).to(cuda, dtype).contiguous(
        memory_format=torch.channels_last)
    scale = (torch.rand(c, generator=g) + 0.5).to(cuda)
    shift = (torch.randn(c, generator=g) * 0.3).to(cuda)
    return y, r, scale, shift


@pytest.mark.cuda
@pytest.mark.parametrize("act", [True, False])
@pytest.mark.parametrize("residual", [False, True])
@pytest.mark.parametrize("c", [64, 20, 3])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_kernel_matches_plain(cuda, dtype, c, residual, act):
    # 3 x 7 x 9 = 189 pixels, odd; C 64 takes the vector kernel in both
    # dtypes, 20 in f32 only (a multiple of 4, not of 8), 3 in neither
    # (the pointers of fresh tensors are 16-byte aligned)
    y, r, scale, shift = _case(cuda, (3, c, 7, 9), dtype)
    res = r if residual else None
    y0 = y.clone()
    before = CE.launches
    got = CE.conv_epilogue(y, scale, shift, act, res)
    torch.cuda.synchronize()
    assert CE.launches == before + 1
    assert got.data_ptr() == y.data_ptr()  # in place
    _check_kernel(got, y0, scale, shift, act, res)


@pytest.mark.cuda
@pytest.mark.parametrize("residual", [False, True])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_kernel_misaligned_takes_the_scalar_path(cuda, dtype, residual):
    n, c, h, w = 2, 64, 5, 7
    y0, r, scale, shift = _case(cuda, (n, c, h, w), dtype, seed=1)
    buf = torch.empty(y0.numel() + 1, dtype=dtype, device=cuda)
    strides = (h * w * c, 1, w * c, c)  # channels_last, one element in
    y = torch.as_strided(buf, (n, c, h, w), strides, storage_offset=1)
    y.copy_(y0)
    assert y.is_contiguous(memory_format=torch.channels_last)
    assert y.data_ptr() % 16 != 0
    before = CE.launches
    got = CE.conv_epilogue(y, scale, shift, True, r if residual else None)
    torch.cuda.synchronize()
    assert CE.launches == before + 1 and got.data_ptr() == y.data_ptr()
    _check_kernel(got, y0, scale, shift, True, r if residual else None)


@pytest.mark.cuda
def test_kernel_refuses_other_layouts(cuda):
    """A card tensor the kernel cannot take is a ValueError, never the
    plain version: y or the residual not contiguous in channels_last."""
    y, r, scale, shift = _case(cuda, (2, 16, 6, 6), torch.bfloat16, seed=2)
    for yy, rr in ((y.contiguous(), None), (y, r.contiguous())):
        before = CE.launches
        with pytest.raises(ValueError, match="channels_last"):
            CE.conv_epilogue(yy, scale, shift, True, rr)
        assert CE.launches == before


@pytest.mark.cuda
def test_fused_model_on_the_card(cuda):
    """The tiny model in bf16 channels_last on the card, fused against
    unfused: every call but the two 1x1 maps launches the kernel."""
    model, _ = build_model(tiny_cfg(), seg_upsample=False, fuse_focus=True)
    randomize_bn(model, seed=0)
    model = model.to(cuda, torch.bfloat16, memory_format=torch.channels_last)
    x = _image(64, False, torch.bfloat16).to(cuda).contiguous(
        memory_format=torch.channels_last)
    with torch.inference_mode():
        want = _outputs(model(x))
        model.fuse()
        before = CE.launches
        got, (fused, plain) = _counted(lambda: _outputs(model(x)))
        torch.cuda.synchronize()
    assert (fused, plain) == (70, 2)
    assert CE.launches == before + 70
    for g, w in zip(got, want):
        assert g.dtype == w.dtype
        scale = w.float().abs().max().item()
        assert (g.float() - w.float()).abs().max().item() <= 2 ** -5 * scale
