"""Kernel K5's module (``desenet_tpu_torch/ops/stem_pallas.py``) and the
Focus fold (``utils/fold.py``) against the JAX package, on the CPU.

(a) ``stem_weight_matrix`` equals the JAX one element for element;
(b) the port's ``stem_conv`` (its plain version on a CPU tensor) against the
    JAX ``stem_conv`` with Pallas in interpret mode and against the JAX
    ``stem_conv_reference``, on the same numpy inputs: f32 at rtol/atol
    1e-5 (the bar tests/test_stem_pallas.py holds the TPU kernel to), bf16
    at ``testing.BF16_BAR`` of the largest JAX value;
(c) ``fold_focus`` of the tiny_psp2 port model's Focus, random BN
    statistics, through ``stem_conv`` against the module's output, f32
    rtol/atol 1e-4, also on a 2x2 image whose Focus conv sees a 1x1 map and
    skips its BN;
(d) the JAX tiny model's ``l0`` (its fused 6x6 stem) output against the
    port's ``stem_conv`` on the JAX ``l0`` kernel with ``fold_conv_bn`` of
    the JAX BN arrays, f32 rtol/atol 1e-4;
(f) the tensor-core kernel's layouts, as the module states them: the tap
    matrix in the kernel's K order (ky, kx*3 + c) times the patches in that
    order equals ``stem_conv_plain`` and the JAX ``stem_conv`` in interpret
    mode at rtol/atol 1e-5 in f32 for CO 32, 48 and 64; the B fragments
    (``stem_weight_fragments``), multiplied and stored as the kernel's
    lanes do it, give the same; ``pick_variant`` picks the kernel by dtype;
(e) the folds' helpers equal the JAX package's, and ``fold_conv`` (shared
    with the seg head's fold) equals ``fold_conv_bn`` on a port conv's
    weights and BN.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import yaml
from flax import traverse_util

from desenet_tpu.models import build_model as jax_build_model
from desenet_tpu.models import init_model
from desenet_tpu.ops import stem_pallas as jax_stem
from desenet_tpu.utils.profiling import fold_conv_bn as jax_fold_conv_bn
from desenet_tpu.utils.torch_convert import \
    _focus_kernel_to_conv as jax_focus_to_conv
from desenet_tpu_torch.models import build_model
from desenet_tpu_torch.models.layers import ConvBnAct
from desenet_tpu_torch.ops import stem_pallas
from desenet_tpu_torch.testing import check_close, randomize_bn, stem_inputs
from desenet_tpu_torch.utils import fold
from desenet_tpu_torch.utils.convert import _conv_kernel_to_focus

HERE = os.path.dirname(os.path.abspath(__file__))


def tiny_cfg():
    with open(os.path.join(HERE, "configs", "tiny_psp2.yaml")) as fh:
        return yaml.safe_load(fh)


@pytest.mark.parametrize("co", [8, 24, 64])
def test_stem_weight_matrix_matches_jax(co):
    _, w6, _ = stem_inputs(1, 2, 2, co, seed=co)
    for jdt, tdt in ((jnp.float32, torch.float32),
                     (jnp.bfloat16, torch.bfloat16)):
        want = np.asarray(jax_stem.stem_weight_matrix(w6, jdt), np.float32)
        got = stem_pallas.stem_weight_matrix(w6, tdt)
        assert got.shape == (stem_pallas.K_PAD, co) and got.dtype == tdt
        np.testing.assert_array_equal(got.float().numpy(), want)
    assert not got[stem_pallas.K_TAPS:].any()


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("silu", [True, False])
@pytest.mark.parametrize("hw,co", [((64, 64), 24), ((96, 64), 64)])
def test_stem_conv_matches_jax(hw, co, silu, dtype):
    x, w6, bias = stem_inputs(2, *hw, co, seed=hw[0] + co)
    jdt, tdt = getattr(jnp, dtype), getattr(torch, dtype)
    jx = jnp.asarray(x.numpy(), jdt)
    want_kernel = np.asarray(jax_stem.stem_conv(
        jx, jax_stem.stem_weight_matrix(w6, jdt), jnp.asarray(bias),
        silu=silu, block_rows=16, interpret=True), np.float32)
    want_ref = np.asarray(jax_stem.stem_conv_reference(
        jx, jnp.asarray(w6), jnp.asarray(bias), silu=silu), np.float32)
    got = stem_pallas.stem_conv(x.to(tdt),
                                stem_pallas.stem_weight_matrix(w6, tdt),
                                torch.from_numpy(bias), silu=silu)
    assert got.shape == (2, hw[0] // 2, hw[1] // 2, co) and got.dtype == tdt
    for want in (want_kernel, want_ref):
        check_close(got, torch.tensor(want), "K5 vs JAX", 1e-5)
    ref = stem_pallas.stem_conv_reference(x.to(tdt), w6, bias, silu)
    np.testing.assert_allclose(ref.float().numpy(), want_ref, rtol=1e-5,
                               atol=1e-5)


@pytest.mark.parametrize("hw", [(64, 64), (64, 96), (2, 2)])
def test_fold_focus_reproduces_the_module(hw):
    model, _ = build_model(tiny_cfg())
    focus = randomize_bn(model.model[0], seed=hw[1])
    x = torch.rand((2, 3, *hw), generator=torch.Generator().manual_seed(0))
    with torch.no_grad():
        want = focus(x).permute(0, 2, 3, 1)
    w6, bias = fold.fold_focus(focus, hw)
    got = stem_pallas.stem_conv(x.permute(0, 2, 3, 1).contiguous(),
                                stem_pallas.stem_weight_matrix(
                                    w6, torch.float32),
                                torch.from_numpy(bias))
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=1e-4,
                               atol=1e-4)


def test_stem_conv_on_the_jax_l0_weights():
    jmodel, spec = jax_build_model(tiny_cfg(), seg_upsample=True)
    assert spec.layers[0].name == "FusedFocus"
    v = jax.device_get(init_model(jmodel, jax.random.PRNGKey(0), img_size=64,
                                  batch=1))
    rng = np.random.default_rng(5)
    flat = traverse_util.flatten_dict(v, sep="/")
    for k in list(flat):
        if k.startswith("batch_stats/l0/") or k.startswith("params/l0/bn/"):
            flat[k] = (np.abs(rng.normal(size=flat[k].shape)) + 0.5).astype(
                np.float32)
    v = traverse_util.unflatten_dict(flat, sep="/")
    x = rng.uniform(0, 1, (2, 64, 64, 3)).astype(np.float32)
    _, state = jmodel.apply(
        v, x, train=False, mutable=["intermediates"],
        capture_intermediates=lambda mdl, name: mdl.name == "l0")
    want = np.asarray(state["intermediates"]["l0"]["__call__"][0])
    assert want.shape == (2, 32, 32, 8)

    bn = {k.rsplit("/", 1)[1]: np.asarray(flat[k]) for k in flat
          if "/l0/bn/" in k}
    w6, bias = fold.fold_conv_bn(
        np.asarray(flat["params/l0/conv/conv2d/kernel"]), None, bn["scale"],
        bn["bias"], bn["mean"], bn["var"])
    got = stem_pallas.stem_conv(torch.from_numpy(x),
                                stem_pallas.stem_weight_matrix(
                                    w6, torch.float32),
                                torch.from_numpy(bias.astype(np.float32)))
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-4, atol=1e-4)


def test_fold_helpers_match_jax():
    rng = np.random.default_rng(7)
    k = rng.normal(size=(3, 3, 12, 16)).astype(np.float32)
    stats = [rng.uniform(0.5, 1.5, 16).astype(np.float32) for _ in range(4)]
    for bias in (None, rng.normal(size=16).astype(np.float32)):
        for a, b in zip(fold.fold_conv_bn(k, bias, *stats),
                        jax_fold_conv_bn(k, bias, *stats)):
            np.testing.assert_array_equal(a, b)
    w = rng.normal(size=(16, 12, 3, 3)).astype(np.float32)
    w6 = fold._focus_kernel_to_conv(w)
    np.testing.assert_array_equal(w6, jax_focus_to_conv(w))
    np.testing.assert_array_equal(_conv_kernel_to_focus(w6), w)


@pytest.mark.parametrize("with_bn", [True, False])
@pytest.mark.parametrize("k", [1, 3])
def test_fold_conv_matches_jax_fold_conv_bn(k, with_bn):
    cba = randomize_bn(ConvBnAct(12, 16, k).eval(), seed=k)
    w, b = fold.fold_conv(cba.conv, cba.bn if with_bn else None)
    kernel = np.transpose(cba.conv.weight.detach().numpy(), (2, 3, 1, 0))
    bn = cba.bn
    want_w, want_b = (jax_fold_conv_bn(
        kernel, None, *(t.detach().numpy() for t in (
            bn.weight, bn.bias, bn.running_mean, bn.running_var)))
        if with_bn else (kernel, np.zeros(16, np.float32)))
    assert w.shape == ((12, 16) if k == 1 else (3, 3, 12, 16))
    np.testing.assert_allclose(w.numpy(), want_w.reshape(w.shape), rtol=1e-6,
                               atol=1e-7)
    np.testing.assert_allclose(b.numpy(), want_b, rtol=1e-6, atol=1e-7)


def test_stem_conv_refuses_what_it_does_not_take():
    x, w6, bias = stem_inputs(1, 8, 8, 16)
    wm = stem_pallas.stem_weight_matrix(w6, torch.float32)
    b = torch.from_numpy(bias)
    with pytest.raises(ValueError, match="H, W even"):
        stem_pallas.stem_conv(x[:, :7], wm, b)
    with pytest.raises(TypeError, match="float32 or bfloat16"):
        stem_pallas.stem_conv(x.double(), wm, b)
    with pytest.raises(ValueError, match="multiple of 8"):
        stem_pallas.stem_conv(x, wm[:, :12], b[:12])
    with pytest.raises(ValueError, match="bias"):
        stem_pallas.stem_conv(x, wm, b[:8])
    with pytest.raises(ValueError, match="CPU or CUDA"):
        stem_pallas.stem_conv(x.to("meta"), wm.to("meta"), b.to("meta"))
    with pytest.raises(ValueError, match="6, 6, 3"):
        stem_pallas.stem_weight_matrix(w6[:5])


@pytest.mark.parametrize("co", [32, 48, 64])
def test_kernel_order_matches_plain_and_jax(co):
    x, w6, bias = stem_inputs(2, 24, 40, co, seed=co)
    wm = stem_pallas.stem_weight_matrix(w6, torch.float32)
    b = torch.from_numpy(bias)
    wk = stem_pallas.stem_weight_kernel_order(wm)
    assert wk.shape == (stem_pallas.K_PAD, co)
    assert not wk[stem_pallas.K_TAPS:].any()
    # row ky*18 + kx*3 + c is tap W[ky, kx, c]
    np.testing.assert_array_equal(wk[:108].numpy(), w6.reshape(108, co))
    patches = stem_pallas.stem_patches_kernel_order(x)
    assert patches.shape == (2, 12, 20, 108)
    y = torch.matmul(patches, wk[:108]) + b
    got = y * torch.sigmoid(y)
    want = stem_pallas.stem_conv_plain(x, wm, b)
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5)
    jwant = np.asarray(jax_stem.stem_conv(
        jnp.asarray(x.numpy()), jax_stem.stem_weight_matrix(w6, jnp.float32),
        jnp.asarray(bias), block_rows=4, interpret=True), np.float32)
    np.testing.assert_allclose(got.numpy(), jwant, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("co", [8, 24, 32, 40, 48, 64])
def test_weight_fragments_as_the_lanes_use_them(co):
    """Walk the mma.sync m16n8k16 layouts in numpy: lane 4g + t of n-tile nt
    holds B[k, n = g] for k = 16 ks + 2t + 8r + h, and C columns 2t, 2t + 1;
    in a pass of nj n-tiles it stores them at channels 32 pass + 2 nj t + 2 j
    + {0, 1}. The result must be the plain conv before the bias."""
    x, w6, _ = stem_inputs(1, 8, 12, co, seed=co + 1)
    wm = stem_pallas.stem_weight_matrix(w6, torch.float32)
    frag = stem_pallas.stem_weight_fragments(wm).numpy()
    nts = co // 8
    assert frag.shape == (7, nts, 32, 2, 2)
    patches = np.zeros((24, 112), np.float32)
    patches[:, :108] = stem_pallas.stem_patches_kernel_order(x).reshape(
        24, 108).numpy()
    out = np.full((24, co), np.nan, np.float32)
    for nt in range(nts):
        bmat = np.zeros((112, 8), np.float32)
        for lane in range(32):
            g, t = lane // 4, lane % 4
            for ks in range(7):
                for r in range(2):
                    for h in range(2):
                        bmat[16 * ks + 2 * t + 8 * r + h, g] = frag[
                            ks, nt, lane, r, h]
        c = patches @ bmat  # (pixels, 8): the n-tile's C
        p, j = divmod(nt, 4)
        nj = min(4, nts - 4 * p)
        for t in range(4):
            ch0 = 32 * p + 2 * nj * t
            out[:, ch0 + 2 * j] = c[:, 2 * t]
            out[:, ch0 + 2 * j + 1] = c[:, 2 * t + 1]
    want = stem_pallas.stem_conv_plain(x, wm, torch.zeros(co), silu=False)
    np.testing.assert_allclose(out, want.reshape(24, co).numpy(), rtol=1e-5,
                               atol=1e-5)
    # the channels are dealt once each
    assert sorted(stem_pallas.fragment_channels(co).reshape(-1)) == list(
        range(co))


def test_pick_variant():
    assert stem_pallas.pick_variant(torch.bfloat16) == "mma"
    assert stem_pallas.pick_variant(torch.float32) == "fma"
