"""int8 W8A8 post-training quantization, JAX (desenet_tpu/quant.py) vs the
port (desenet_tpu_torch/quant.py, ops/int8_conv.py), on the CPU.

The same seeded numpy inputs and the same weights (the port's boosted
tiny_psp2 weights, ``testing.boosted_state``, crossed into flax variables by
the JAX package's ``convert_state_dict``) go through both packages:

- the quant.py helpers bit-exact (quantize, dequantize, requantize, slices,
  both concats, the residual add, the int8 max pool and nearest upsample),
  the int8 average pools and bilinear resizes within 1 LSB (XLA orders its
  f32 sums its own way), the percentile within 1e-5, ``quantize_kernel``
  with and without ``mse_clip`` (int8 equal, scales within 1 ulp);
- one ConvBnAct int8 block (3x3 and 1x1, a 1x1-spatial input that skips
  the BN fold, per-tensor and per-channel input scales, bias correction):
  int8 outputs within 1 LSB everywhere and equal on at least 99.9% of the
  elements;
- calibration of the tiny model at 64 px, batch 2: the same 107 site keys
  and 52 input-mean keys as JAX's flax scope paths; scales within 1e-5
  relative and means within 1e-5 of the site's largest |mean| (float32
  convolutions summed in another order, through up to 20 layers, move the
  deepest sites' percentiles by up to 5e-6);
- the whole tiny int8 model on JAX's calibrated scales, per channel and per
  tensor, det_fp_hops 1 and 2, and weights-only: decode and seg logits
  within 2% of their largest magnitude, the seg class map equal on at least
  99% of the pixels; and the port's int8 model against its fp model at the
  JAX package's own bars (tests/test_quant.py);
- grouped convs: one ConvBnAct int8 block at g 2, 4 and depthwise (a
  per-channel input scale requantized to one per-tensor scale, no bias
  correction, as ``int8_conv_block`` does) at the block bar above, and the
  whole int8 model of ``testing.GROUPED_CFG`` on JAX's calibrated scales
  (its det features within 2% of their largest magnitude); the plain
  version's grouped int32 sums equal an int64 product group by group, and
  the packed weights hold each output channel's group.

One module-scoped JAX model, calibration and jitted forward a variant keep
the file's time down; torch runs on one thread.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import yaml

from desenet_tpu import quant as JQ
from desenet_tpu.models import build_model as jax_build_model
from desenet_tpu.models.layers import ConvBnAct as JaxConvBnAct
from desenet_tpu.utils.torch_convert import convert_state_dict
from desenet_tpu_torch import quant as Q
from desenet_tpu_torch.models import build_model
from desenet_tpu_torch.models.layers import ConvBnAct, set_quant
from desenet_tpu_torch.ops import int8_conv
from desenet_tpu_torch.testing import (GROUPED_CFG, INT8_CONV_CASES,
                                       INT8_GROUPED_CASES, boosted_state,
                                       int8_conv_case,
                                       realistic_convbnact_state)
from desenet_tpu_torch.utils.convert import load_state_dict, quant_cfg_from_jax

CFG = "tests/configs/tiny_psp2.yaml"


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def nchw(a: np.ndarray) -> torch.Tensor:
    return torch.from_numpy(np.array(a.transpose(0, 3, 1, 2)))  # a copy


def nhwc(t: torch.Tensor) -> np.ndarray:
    return t.detach().permute(0, 2, 3, 1).numpy()


# ---- the helpers ------------------------------------------------------------


def test_qt_helpers_bit_exact():
    rng = np.random.default_rng(0)
    x = rng.normal(0, 1, (2, 6, 6, 8)).astype(np.float32)
    s = float(np.abs(x).max()) / 127.0
    sv = tuple(float(v) for v in np.abs(x).max((0, 1, 2)) / 127.0)
    for scale in (s, sv):
        jq, pq = JQ.quantize(jnp.asarray(x), scale), Q.quantize(nchw(x), scale)
        np.testing.assert_array_equal(np.asarray(jq.data), nhwc(pq.data))
        np.testing.assert_array_equal(np.asarray(JQ.dequantize(jq)),
                                      nhwc(Q.dequantize(pq)))
        for to in (2 * s, tuple(2 * v for v in sv)):
            if isinstance(to, tuple) != isinstance(scale, tuple):
                continue
            np.testing.assert_array_equal(
                np.asarray(JQ.requantize(jq, to).data),
                nhwc(Q.requantize(pq, to).data))
        js, ps = JQ.qt_slice(jq, 2, 5), Q.qt_slice(pq, 2, 5)
        assert js.scale == ps.scale
        np.testing.assert_array_equal(np.asarray(js.data), nhwc(ps.data))
    a = (JQ.quantize(jnp.asarray(x), s), Q.quantize(nchw(x), s))
    b = (JQ.quantize(jnp.asarray(3 * x), 3 * s), Q.quantize(nchw(3 * x), 3 * s))
    c = (JQ.quantize(jnp.asarray(x), sv), Q.quantize(nchw(x), sv))
    for parts in ((a, b), (c, c)):
        jc = JQ.qt_concat([p[0] for p in parts])
        pc = Q.qt_concat([p[1] for p in parts])
        assert jc.scale == pc.scale
        np.testing.assert_array_equal(np.asarray(jc.data), nhwc(pc.data))
    np.testing.assert_array_equal(
        np.asarray(JQ.qt_add(a[0], b[0], 2.5 * s).data),
        nhwc(Q.qt_add(a[1], b[1], 2.5 * s).data))
    np.testing.assert_array_equal(
        np.asarray(jax.lax.reduce_window(
            a[0].data, np.int8(-128), jax.lax.max, (1, 5, 5, 1), (1, 1, 1, 1),
            ((0, 0), (2, 2), (2, 2), (0, 0)))),
        nhwc(Q.qt_max_pool(a[1], 5).data))
    up = np.asarray(a[0].data).repeat(2, 1).repeat(2, 2)
    np.testing.assert_array_equal(up, nhwc(Q.qt_upsample_nearest(a[1], 2).data))


def _within_one_lsb(a: np.ndarray, b: np.ndarray, equal: float) -> None:
    d = np.abs(a.astype(np.int32) - b.astype(np.int32))
    assert d.max() <= 1 and (d == 0).mean() >= equal, (d.max(),
                                                      (d == 0).mean())


@pytest.mark.parametrize("k", [1, 2, 3, 6])
def test_qt_pool_and_resize(k):
    """The int8 pools and align_corners resizes, the separable f32
    contraction as JAX's. XLA orders the f32 sums its own way, and
    rounding a resample back to int8 shows that: within 1 LSB, equal on at
    least 99% of the elements (the global mean, k 1, is equal)."""
    rng = np.random.default_rng(k)
    x = rng.normal(0, 1, (2, 12, 12, 16)).astype(np.float32)
    s = float(np.abs(x).max()) / 127.0
    jq, pq = JQ.quantize(jnp.asarray(x), s), Q.quantize(nchw(x), s)
    jp, pp = JQ.qt_global_avg_pool(jq, k), Q.qt_global_avg_pool(pq, k)
    _within_one_lsb(np.asarray(jp.data), nhwc(pp.data),
                    1.0 if k == 1 else 0.99)
    jr = JQ.qt_resize_bilinear(jp, (12, 12), align_corners=True)
    pr = Q.qt_resize_bilinear(jp_as_port(jp), (12, 12), align_corners=True)
    _within_one_lsb(np.asarray(jr.data), nhwc(pr.data), 0.99)


def jp_as_port(q) -> Q.QTensor:
    return Q.QTensor(nchw(np.asarray(q.data)), q.scale)


def test_percentile_matches_jnp_and_takes_large_tensors():
    """jnp.percentile's linear interpolation on float32 index arithmetic;
    XLA folds that arithmetic its own way (an ulp of the index at some
    sizes), so within 1e-5 relative."""
    rng = np.random.default_rng(1)
    for n in (7, 1000, 12345, 100001):
        a = np.abs(rng.normal(0, 1, n)).astype(np.float32)
        want = float(jnp.percentile(jnp.asarray(a), 99.9))
        got = float(Q.percentile(torch.from_numpy(a), 99.9))
        assert abs(got - want) <= 1e-5 * want, (n, got, want)
    # over 2^24 elements, where torch.quantile refuses
    big = torch.rand(2 ** 24 + 3, generator=torch.Generator().manual_seed(0))
    with pytest.raises(RuntimeError):
        torch.quantile(big, 0.999)
    srt = torch.sort(big).values
    qi = np.float32(np.float32(0.999) * np.float32(big.numel() - 1))
    lo = int(np.floor(qi))
    hw = float(np.float32(qi - np.float32(lo)))
    want = srt[lo] * (1.0 - hw) + srt[lo + 1] * hw
    assert abs(float(Q.percentile(big, 99.9)) - float(want)) <= 1e-7


@pytest.mark.parametrize("mse_clip", [False, True])
def test_quantize_kernel(mse_clip):
    rng = np.random.default_rng(2)
    for w in (rng.normal(0, 0.05, (3, 3, 32, 16)),
              rng.laplace(0, 0.03, (3, 3, 32, 16)),
              rng.standard_t(3, (1, 1, 24, 8)) * 0.02):
        w = w.astype(np.float32)
        jq, js = JQ.quantize_kernel(jnp.asarray(w), mse_clip=mse_clip)
        pq, ps = Q.quantize_kernel(torch.from_numpy(
            np.ascontiguousarray(w.transpose(3, 2, 0, 1))), mse_clip=mse_clip)
        np.testing.assert_array_equal(np.asarray(jq).transpose(3, 2, 0, 1),
                                      pq.numpy())
        np.testing.assert_array_max_ulp(np.asarray(js), ps.numpy(), 1)


def test_mse_clip_never_worse_than_absmax():
    rng = np.random.default_rng(3)
    w = torch.tensor(rng.standard_t(3, (16, 32, 3, 3)) * 0.02,
                     dtype=torch.float32)
    qa, sa = Q.quantize_kernel(w)
    qm, sm = Q.quantize_kernel(w, mse_clip=True)
    err_a = float(((qa * sa.view(-1, 1, 1, 1) - w) ** 2).sum())
    err_m = float(((qm * sm.view(-1, 1, 1, 1) - w) ** 2).sum())
    assert err_m <= err_a * (1 + 1e-6)


# ---- one ConvBnAct block ------------------------------------------------------


def _jax_block_vars(sd: dict) -> dict:
    return {
        "params": {
            "conv": {"conv2d": {"kernel": jnp.asarray(
                sd["conv.weight"].numpy().transpose(2, 3, 1, 0))}},
            "bn": {"bn": {"scale": jnp.asarray(sd["bn.weight"].numpy()),
                          "bias": jnp.asarray(sd["bn.bias"].numpy())}},
        },
        "batch_stats": {"bn": {"bn": {
            "mean": jnp.asarray(sd["bn.running_mean"].numpy()),
            "var": jnp.asarray(sd["bn.running_var"].numpy())}}},
    }


@pytest.mark.parametrize("c1,c2,k,hw,per_channel,bias_correct", [
    (32, 48, 3, 16, False, False),
    (32, 48, 3, 16, True, True),
    (21, 40, 1, 8, True, True),
    (16, 16, 1, 1, False, True),   # 1x1 spatial: the BN fold is skipped
    (16, 24, 1, 1, True, False),
])
def test_convbnact_int8_block(c1, c2, k, hw, per_channel, bias_correct):
    rng = np.random.default_rng(c1 + k + hw)
    sd = realistic_convbnact_state(rng, c1, c2, k)
    x = rng.normal(0.3, 1, (2, hw, hw, c1)).astype(np.float32)
    calib = JaxConvBnAct(c2, k, quant=JQ.QuantCfg(
        mode="calib", per_channel_act=per_channel))
    _, mut = calib.apply(_jax_block_vars(sd), jnp.asarray(x), train=False,
                         mutable=["qcal", "qmean"])
    scales = tuple(sorted(JQ.flatten_qcal(mut["qcal"]).items()))
    means = tuple(sorted((kk, tuple(float(v) for v in vv)) for kk, vv in
                         JQ.flatten_qmean(mut["qmean"]).items()))
    cfg = dict(mode="int8", scales=scales, in_means=means,
               bias_correct=bias_correct, per_channel_act=per_channel)
    s_in = dict(scales)["in"]
    jq = JaxConvBnAct(c2, k, quant=JQ.QuantCfg(**cfg)).apply(
        _jax_block_vars(sd), JQ.quantize(jnp.asarray(x), s_in), train=False)

    block = ConvBnAct(c1, c2, k).eval()
    block.load_state_dict(sd)
    set_quant(block, Q.QuantCfg(**cfg), "", None)  # top level: bare keys
    with torch.no_grad():
        pq = block.qforward(Q.quantize(nchw(x), s_in))
    assert pq.scale == jq.scale
    _within_one_lsb(np.asarray(jq.data), nhwc(pq.data), 0.999)


@pytest.mark.parametrize("c1,c2,k,s,g,per_channel", [
    (32, 48, 3, 1, 2, False),
    (32, 64, 1, 2, 4, True),
    (32, 32, 3, 1, 32, True),     # depthwise
    (16, 16, 5, 2, 16, False),    # GhostConv's cheap 5x5
])
def test_grouped_convbnact_int8_block(c1, c2, k, s, g, per_channel):
    rng = np.random.default_rng(c1 + k + g)
    sd = realistic_convbnact_state(rng, c1 // g, c2, k)
    x = rng.normal(0.3, 1, (2, 16, 16, c1)).astype(np.float32)
    calib = JaxConvBnAct(c2, k, s, g=g, quant=JQ.QuantCfg(
        mode="calib", per_channel_act=per_channel))
    _, mut = calib.apply(_jax_block_vars(sd), jnp.asarray(x), train=False,
                         mutable=["qcal", "qmean"])
    scales = tuple(sorted(JQ.flatten_qcal(mut["qcal"]).items()))
    means = tuple(sorted((kk, tuple(float(v) for v in vv)) for kk, vv in
                         JQ.flatten_qmean(mut["qmean"]).items()))
    cfg = dict(mode="int8", scales=scales, in_means=means,
               bias_correct=True, per_channel_act=per_channel)
    s_in = dict(scales)["in"]
    assert isinstance(s_in, tuple) == per_channel
    jq = JaxConvBnAct(c2, k, s, g=g, quant=JQ.QuantCfg(**cfg)).apply(
        _jax_block_vars(sd), JQ.quantize(jnp.asarray(x), s_in), train=False)

    block = ConvBnAct(c1, c2, k, s, g=g).eval()
    block.load_state_dict(sd)
    set_quant(block, Q.QuantCfg(**cfg), "", None)
    with torch.no_grad():
        pq = block.qforward(Q.quantize(nchw(x), s_in))
    assert pq.scale == jq.scale
    _within_one_lsb(np.asarray(jq.data), nhwc(pq.data), 0.999)


def test_grouped_int8_model_matches_jax():
    cfg = GROUPED_CFG
    port_model, _ = build_model(cfg)
    sd = boosted_state(port_model, seed=0)
    jmodel, jspec = jax_build_model(cfg)
    shapes = jax.eval_shape(
        lambda v: jmodel.init({"params": jax.random.PRNGKey(0),
                               "dropout": jax.random.PRNGKey(0)}, v,
                              train=False),
        jax.ShapeDtypeStruct((1, 64, 64, 3), np.float32))
    template = jax.tree.map(lambda s: np.zeros(s.shape, s.dtype), shapes)
    variables, report = convert_state_dict(
        {k: v.numpy() for k, v in sd.items()}, template, jspec)
    assert not report["missing"]
    x = np.random.default_rng(1).uniform(0, 1, (2, 64, 64, 3)).astype(
        np.float32)
    cm, _ = jax_build_model(cfg, quant=JQ.QuantCfg(mode="calib"))
    jscales, jmeans = JQ.calibrate_stats(cm, variables, [jnp.asarray(x)])
    qcfg = JQ.QuantCfg(mode="int8", scales=jscales, in_means=jmeans)
    jm, _ = jax_build_model(cfg, quant=qcfg)
    (_, jfeats), _ = jax.jit(lambda v, a: jm.apply(v, a, train=False))(
        variables, jnp.asarray(x))
    pm, _ = build_model(cfg, fuse_focus=True, quant=Q.QuantCfg(
        mode="int8", scales=jscales, in_means=jmeans))
    load_state_dict(pm, sd)
    grouped = [m for m in pm.modules() if isinstance(m, ConvBnAct)
               and m.conv.groups > 1 and m.quant is not None]
    assert len(grouped) == 5
    with torch.no_grad():
        (_, feats), _ = pm.eval()(nchw(x))
    for got, want in zip(feats, jfeats):
        want = np.asarray(want)
        assert np.abs(got.numpy() - want).max() <= 0.02 * np.abs(want).max()


# ---- the tiny model -------------------------------------------------------------


@pytest.fixture(scope="module")
def tiny():
    """(JAX cfg dict, port state dict, JAX variables, input NHWC, JAX fp
    model) on one set of boosted weights."""
    with open(CFG) as fh:
        cfg = yaml.safe_load(fh)
    port_model, _ = build_model(cfg)
    sd = boosted_state(port_model, seed=0)
    jmodel, jspec = jax_build_model(cfg)
    shapes = jax.eval_shape(
        lambda v: jmodel.init({"params": jax.random.PRNGKey(0),
                               "dropout": jax.random.PRNGKey(0)}, v,
                              train=False),
        jax.ShapeDtypeStruct((1, 64, 64, 3), np.float32))
    template = jax.tree.map(lambda s: np.zeros(s.shape, s.dtype), shapes)
    variables, report = convert_state_dict(
        {k: v.numpy() for k, v in sd.items()}, template, jspec)
    assert not report["missing"]
    x = np.random.default_rng(1).uniform(0, 1, (2, 64, 64, 3)).astype(
        np.float32)
    return cfg, sd, variables, x


@pytest.fixture(scope="module", params=[True, False],
                ids=["per_channel", "per_tensor"])
def calibrated(request, tiny):
    cfg, sd, variables, x = tiny
    pc = request.param
    cm, _ = jax_build_model(cfg, quant=JQ.QuantCfg(mode="calib",
                                                   per_channel_act=pc))
    jscales, jmeans = JQ.calibrate_stats(cm, variables, [jnp.asarray(x)])
    pm, _ = build_model(cfg, fuse_focus=True, quant=Q.QuantCfg(
        mode="calib", per_channel_act=pc))
    load_state_dict(pm, sd)
    pscales, pmeans = Q.calibrate_stats(pm.eval(), [nchw(x)])
    return pc, jscales, jmeans, pscales, pmeans


def test_calibration_matches_jax(calibrated):
    pc, jscales, jmeans, pscales, pmeans = calibrated
    assert [k for k, _ in pscales] == [k for k, _ in jscales]
    assert [k for k, _ in pmeans] == [k for k, _ in jmeans]
    assert len(jscales) == 107 and len(jmeans) == 52
    for (k, a), (_, b) in zip(jscales, pscales):
        assert isinstance(a, tuple) == isinstance(b, tuple) == pc, k
        np.testing.assert_allclose(b, a, rtol=1e-5, atol=0, err_msg=k)
    for (k, a), (_, b) in zip(jmeans, pmeans):
        a, b = np.asarray(a), np.asarray(b)
        assert np.abs(a - b).max() <= 1e-5 * np.abs(a).max(), k


def test_quant_cfg_from_jax(calibrated):
    pc, jscales, jmeans, _, _ = calibrated
    jcfg = JQ.QuantCfg(mode="int8", scales=jscales, in_means=jmeans,
                       bias_correct=True, mse_clip=True, per_channel_act=pc)
    cfg = quant_cfg_from_jax(jcfg)
    assert cfg == Q.QuantCfg(mode="int8", scales=jscales, in_means=jmeans,
                             bias_correct=True, mse_clip=True,
                             per_channel_act=pc)


@pytest.fixture(scope="module")
def port_fp(tiny):
    cfg, sd, _, x = tiny
    m, _ = build_model(cfg, fuse_focus=True)
    load_state_dict(m, sd)
    with torch.no_grad():
        (dec, _), seg = m.eval()(nchw(x))
    return dec.numpy(), seg.numpy()


def _cos(a, b):
    a, b = a.ravel(), b.ravel()
    return float(a @ b / (np.linalg.norm(a) * np.linalg.norm(b) + 1e-12))


@pytest.mark.parametrize("hops,weights_only", [(1, False), (2, False),
                                               (1, True)],
                         ids=["hops1", "hops2", "weights_only"])
def test_int8_model_matches_jax(tiny, calibrated, port_fp, hops,
                                weights_only):
    cfg, sd, variables, x = tiny
    pc, jscales, jmeans, _, _ = calibrated
    qcfg = dict(mode="int8", scales=jscales, in_means=jmeans,
                bias_correct=True, per_channel_act=pc,
                weights_only=weights_only)
    jm, _ = jax_build_model(cfg, quant=JQ.QuantCfg(**qcfg), det_fp_hops=hops)
    (jdec, _), jseg = jax.jit(lambda v, a: jm.apply(v, a, train=False))(
        variables, jnp.asarray(x))
    jdec, jseg = np.asarray(jdec), np.asarray(jseg).transpose(0, 3, 1, 2)
    pm, _ = build_model(cfg, fuse_focus=True, quant=Q.QuantCfg(**qcfg),
                        det_fp_hops=hops)
    load_state_dict(pm, sd)
    with torch.no_grad():
        (pdec, _), pseg = pm.eval()(nchw(x))
    pdec, pseg = pdec.numpy(), pseg.numpy()
    assert np.abs(pdec - jdec).max() <= 0.02 * np.abs(jdec).max()
    assert np.abs(pseg - jseg).max() <= 0.02 * np.abs(jseg).max()
    assert (pseg.argmax(1) == jseg.argmax(1)).mean() >= 0.99
    # the port's int8 model against its fp model, at the JAX package's bars
    dec_fp, seg_fp = port_fp
    assert _cos(dec_fp, pdec) > 0.98 and _cos(seg_fp, pseg) > 0.98
    assert np.percentile(np.abs(dec_fp[..., 4:] - pdec[..., 4:]), 99.5) < 0.1
    assert np.abs(dec_fp[..., :2] - pdec[..., :2]).mean() < 1.0


def test_bias_correction_reduces_error():
    """With a biased input, folding the expected weight-rounding shift out
    of the epilogue shrinks the systematic (per-channel mean) error."""
    rng = np.random.default_rng(4)
    sd = realistic_convbnact_state(rng, 32, 48, 3)
    x = torch.tensor(rng.normal(0.7, 0.5, (2, 32, 16, 16)), dtype=torch.float32)
    block = ConvBnAct(32, 48, 3).eval()
    block.load_state_dict(sd)
    with torch.no_grad():
        y_fp = block(x)
    set_quant(block, Q.QuantCfg(mode="calib"), "b", None)
    stats = {}
    with Q.recording(stats), torch.no_grad():
        block.qforward(x)
    scales = tuple(sorted((k, Q._to_scale(v.numpy().astype(np.float64)))
                          for k, (kind, v) in stats.items()
                          if kind == "range"))
    means = tuple((k, tuple(float(u) for u in v.numpy()))
                  for k, (kind, v) in stats.items() if kind == "mean")
    qx = Q.quantize(x, float(x.abs().max()) / 127.0)

    def mean_bias(**kw):
        set_quant(block, Q.QuantCfg(mode="int8", scales=scales,
                                    in_means=means, **kw), "b", None)
        with torch.no_grad():
            y = Q.dequantize(block.qforward(qx))
        return float((y - y_fp).mean(dim=(0, 2, 3)).abs().mean()), y

    plain, _ = mean_bias()
    corrected, y = mean_bias(bias_correct=True)
    assert corrected < plain
    assert float((y - y_fp).abs().mean() / y_fp.abs().mean()) < 0.05


# ---- the int8 conv block's plain version and the kernel's weight layout ----


@pytest.mark.parametrize("case", INT8_CONV_CASES, ids=lambda c: c[0])
def test_int8_conv_plain_is_exact(case):
    """The plain version's int32 sums equal an int64 im2col product (its
    float64 conv is exact here), its outputs have the kernel's shapes and
    dtypes, and the packed weight layout holds every tap and channel of
    every part, zero-padded to a multiple of 32."""
    c = int8_conv_case(case)
    parts, p = c["parts"], c["prep"]
    raw = int8_conv.run(parts, p, out_mode=int8_conv.OUT_I32)
    x = torch.cat(parts, 1).long()
    kh, kw = p.qw.shape[2:]
    cols = torch.nn.functional.unfold(
        x.double(), (kh, kw), dilation=p.dilation, padding=p.padding,
        stride=p.stride).round().long()  # (B, C*kh*kw, L), exact here
    want = torch.einsum("ok,bkl->bol", p.qw.long().reshape(p.qw.shape[0], -1),
                        cols).reshape(raw.shape)
    assert raw.dtype == torch.int32 and torch.equal(raw.long(), want)
    out = int8_conv.run(parts, p, residual=c["residual"],
                        res_scale=c["res_scale"], out_scale=c["out_scale"],
                        act=c["act"], out_mode=c["out_mode"])
    assert out.shape == raw.shape
    assert out.dtype == {int8_conv.OUT_INT8: torch.int8,
                         int8_conv.OUT_F32: torch.float32,
                         int8_conv.OUT_BF16: torch.bfloat16}[c["out_mode"]]
    int8_conv.pack_weights(p)
    assert p.packed.shape[1] % 32 == 0 and p.packed.is_contiguous()
    off = 0
    for chans, koff, kpad, kpack in zip(p.channels, p.koff, p.kpad,
                                        p.kpack):
        w = p.qw[:, off:off + chans].permute(0, 2, 3, 1)  # (O, KH, KW, c)
        off += chans
        assert kpad % 32 == 0 and kpack == (chans < 32)
        if kpack:  # taps and channels as one zero-padded run
            n = kh * kw * chans
            assert kpad - n < 32
            run = p.packed[:, koff:koff + kpad]
            assert torch.equal(run[:, :n], w.reshape(-1, n))
            assert not run[:, n:].any()
            continue
        assert kpad - chans < 32
        blk = p.packed[:, koff:koff + kh * kw * kpad].reshape(-1, kh, kw,
                                                               kpad)
        assert torch.equal(blk[..., :chans], w)
        assert not blk[..., chans:].any()


@pytest.mark.parametrize("case", INT8_GROUPED_CASES, ids=lambda c: c[0])
def test_int8_conv_grouped_plain_is_exact(case):
    """The grouped cases at batch 1 on a 12 x 12 map: the plain version's
    int32 sums equal an int64 im2col product taken group by group, and
    each output channel's packed row holds its group's taps and channels,
    zero-padded to a multiple of 32."""
    c = int8_conv_case((case[0], 1, 12, 12) + case[4:])
    parts, p = c["parts"], c["prep"]
    raw = int8_conv.run(parts, p, out_mode=int8_conv.OUT_I32)
    g, (o, cg, kh, kw) = p.groups, p.qw.shape
    x = parts[0].long()
    cols = torch.nn.functional.unfold(
        x.double(), (kh, kw), dilation=p.dilation, padding=p.padding,
        stride=p.stride).round().long()  # (B, C*kh*kw, L), channel-major
    cols = cols.reshape(1, g, cg * kh * kw, -1)
    w = p.qw.long().reshape(g, o // g, cg * kh * kw)
    want = torch.einsum("gok,bgkl->bgol", w, cols).reshape(raw.shape)
    assert raw.dtype == torch.int32 and torch.equal(raw.long(), want)
    int8_conv.pack_weights(p)
    kpad, kpack = p.kpad[0], p.kpack[0]
    taps = p.qw.permute(0, 2, 3, 1)  # (O, KH, KW, cg)
    assert kpack == (cg < 32) and p.packed.shape[1] % 32 == 0
    if kpack:
        n = kh * kw * cg
        assert torch.equal(p.packed[:, :n], taps.reshape(o, n))
        assert not p.packed[:, n:].any()
    else:
        blk = p.packed.reshape(o, kh, kw, kpad)
        assert torch.equal(blk[..., :cg], taps) and not blk[..., cg:].any()


def test_int8_conv_refuses_other_devices():
    c = int8_conv_case(INT8_CONV_CASES[0])
    with pytest.raises(ValueError, match="CPU or CUDA"):
        int8_conv.run([t.to("meta") for t in c["parts"]], c["prep"])


def test_int8_constants_fold_once_and_drop_on_load():
    """A block's int8 constants are folded at its first call with given
    input scales and reused after; loading new weights drops them, so the
    block then computes what a block built with those weights does."""
    rng = np.random.default_rng(5)
    sd_a = realistic_convbnact_state(rng, 24, 32, 3)
    sd_b = realistic_convbnact_state(rng, 24, 32, 3)
    x = Q.quantize(nchw(rng.normal(0, 1, (1, 8, 8, 24)).astype(np.float32)),
                   1.0 / 40.0)
    cfg = Q.QuantCfg(mode="int8", scales=(("in", 1.0 / 40.0),
                                          ("out", 1.0 / 30.0)))

    def block(sd):
        b = ConvBnAct(24, 32, 3).eval()
        b.load_state_dict(sd)
        set_quant(b, cfg, "", None)
        return b

    blk = block(sd_a)
    with torch.no_grad():
        y_a = blk.qforward(x).data
        (prep,) = blk._derived.values()
        assert torch.equal(blk.qforward(x).data, y_a)
        assert next(iter(blk._derived.values())) is prep
        blk.load_state_dict(sd_b)
        assert not blk._derived
        y_b = blk.qforward(x).data
        assert torch.equal(y_b, block(sd_b).qforward(x).data)
    assert not torch.equal(y_a, y_b)


def test_quantize_for_inference_defaults_to_the_card():
    """The one-call PTQ runs on the card unless the caller asks for the
    CPU: without one it refuses before building anything."""
    import inspect

    sig = inspect.signature(Q.quantize_for_inference)
    assert sig.parameters["device"].default == "cuda"
    if torch.cuda.is_available():
        return
    with pytest.raises(RuntimeError, match="no CUDA card"):
        Q.quantize_for_inference(CFG, {}, [torch.zeros(1, 3, 64, 64)])
