"""fp8 activation storage (``build_model(act_store=...)``), JAX
(desenet_tpu/models/layers.py act_store_scope) vs the port, on the CPU.

- The cast: e4m3fn in JAX gives NaN past the rounding midpoint 464 above
  its largest value (infinities included), where torch saturates to 448;
  the port's ``quant.to_f8`` follows JAX. e5m2 casts agree as they are.
- The tiny model in f32 with fp8 storage (e4m3 and e5m2) on the same
  boosted weights and input: decode and seg logits within rtol 1e-5 of
  JAX's (atol 1e-6 of the largest magnitude), and not equal to the model
  without storage (rounding happened).
- The storage dtype of every row's output: fp8 inside the scope, the
  model dtype for the rows feeding Detect (and with det_fp_hops 2 their
  producers), the heads' outputs in their normal dtypes; JAX's dtypes at
  the same rows.
- Every row the JAX package builds: ``testing.EXOTIC_CFG`` (GhostConv,
  GhostBottleneck, C3Ghost, CrossConv, MixConv2d, DWConv, BottleneckCSP,
  C3TR, C3SPP, Contract, Expand, the standalone BN) and tiny_psp2 with
  the BiSe, Lab and Base seg heads on seeded variables (every conv kernel
  N(0, 1.3 / sqrt(fan_in)), BN at identity), computing in float64 on
  both sides (in f32 the packages' conv sums differ by some 1e-7, enough
  to round a few values to the neighbouring e4m3 value, and such a flip
  spreads through the layers after it): the det features and seg logits
  within rtol 1e-5 and an atol of 1e-5 of the largest magnitude of JAX's
  fp8 forward (they agree to 1e-7 of it; the fp8 resizes run in bf16 on
  both sides), more than ten times that from the port's model without
  storage, and each row's output in JAX's storage dtype (fp8 where the
  JAX block ends in a stored conv or sum, the compute dtype after
  CrossConv, MixConv2d and the BN row).
- Training mode is untouched; int8 and fp8 storage exclude each other.
"""

import copy

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import yaml
from flax import traverse_util

from desenet_tpu.models import build_model as jax_build_model
from desenet_tpu.utils.torch_convert import convert_state_dict
from desenet_tpu_torch import quant as Q
from desenet_tpu_torch.models import build_model
from desenet_tpu_torch.models.build import det_fp_layers
from desenet_tpu_torch.quant import to_f8
from desenet_tpu_torch.testing import EXOTIC_CFG, boosted_state
from desenet_tpu_torch.utils.convert import (load_state_dict,
                                             state_dict_from_jax)

CFG = "tests/configs/tiny_psp2.yaml"
JAX_F8 = {"fp8": jnp.float8_e4m3fn, "fp8_e5m2": jnp.float8_e5m2}
TORCH_F8 = {"fp8": torch.float8_e4m3fn, "fp8_e5m2": torch.float8_e5m2}


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.mark.parametrize("store", ["fp8", "fp8_e5m2"])
@pytest.mark.parametrize("src", ["float32", "bfloat16"])
def test_f8_cast_matches_jax(store, src):
    vals = np.array([0.0, -0.0, 1e-9, 0.1, 1.7, 240.0, 448.0, 456.0, 460.0,
                     464.0, 464.5, 465.0, 480.0, 500.0, -470.0, 57344.0,
                     61440.0, 1e6, np.inf, -np.inf, np.nan], np.float32)
    rng = np.random.default_rng(0)
    vals = np.concatenate([vals, rng.normal(0, 200, 2000).astype(np.float32)])
    want = np.asarray(jnp.asarray(vals, getattr(jnp, src)).astype(
        JAX_F8[store]).astype(jnp.float32))
    got = to_f8(torch.from_numpy(vals).to(getattr(torch, src)),
                TORCH_F8[store]).float().numpy()
    np.testing.assert_array_equal(got, want)
    if store == "fp8":  # torch's own cast saturates where JAX's is NaN
        assert float(torch.tensor(500.0).to(torch.float8_e4m3fn)) == 448.0
        assert np.isnan(got[vals == 500.0]).all()


@pytest.fixture(scope="module")
def tiny():
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


def _port(cfg, sd, **kw):
    m, spec = build_model(cfg, fuse_focus=True, **kw)
    load_state_dict(m, sd)
    return m.eval(), spec


def _nchw(x):
    return torch.from_numpy(np.ascontiguousarray(x.transpose(0, 3, 1, 2)))


@pytest.mark.parametrize("store", ["fp8", "fp8_e5m2"])
def test_act_store_model_matches_jax(tiny, store):
    cfg, sd, variables, x = tiny
    jm, _ = jax_build_model(cfg, act_store=store)
    (jdec, _), jseg = jax.jit(lambda v, a: jm.apply(v, a, train=False))(
        variables, jnp.asarray(x))
    jdec, jseg = np.asarray(jdec), np.asarray(jseg).transpose(0, 3, 1, 2)
    m, _ = _port(cfg, sd, act_store=store)
    m0, _ = _port(cfg, sd)
    with torch.no_grad():
        (dec, _), seg = m(_nchw(x))
        (dec0, _), seg0 = m0(_nchw(x))
    assert dec.dtype == torch.float32 and seg.dtype == torch.float32
    for got, want in ((dec.numpy(), jdec), (seg.numpy(), jseg)):
        np.testing.assert_allclose(got, want, rtol=1e-5,
                                   atol=1e-6 * np.abs(want).max())
    assert not torch.equal(dec, dec0) and not torch.equal(seg, seg0)


@pytest.mark.parametrize("hops", [1, 2])
def test_storage_dtypes_and_det_src_exclusion(tiny, hops):
    cfg, sd, variables, x = tiny
    m, spec = _port(cfg, sd, act_store="fp8", det_fp_hops=hops)
    rows, run = {}, m._row

    def record(ls, mod, inp, cd, qmode):
        rows[ls.i] = out = run(ls, mod, inp, cd, qmode)
        return out

    m._row = record
    with torch.no_grad():
        m(_nchw(x))
    fp_rows = det_fp_layers(spec, hops)
    assert set(spec.layers[spec.det_layer].f) <= fp_rows
    if hops == 2:
        assert len(fp_rows) > 3
    for ls in spec.layers:  # the compute rows (pass-through rows carry
        if ls.name in ("Detect", "SegMaskPSP2", "Upsample", "Concat"):
            continue  # their inputs' dtypes)
        want = torch.float32 if ls.i in fp_rows else torch.float8_e4m3fn
        assert rows[ls.i].dtype == want, (ls.i, ls.name, rows[ls.i].dtype)
    assert rows[spec.seg_layer].dtype == torch.float32
    # JAX's storage dtypes at a scoped row and at the fp rows
    jm, _ = jax_build_model(cfg, act_store="fp8", det_fp_hops=hops)
    for i in (2, max(fp_rows)):
        out = jm.apply(variables, jnp.asarray(x), train=False, up_to=i)
        want = torch.float32 if i in fp_rows else torch.float8_e4m3fn
        assert str(out.dtype) == str(want).replace("torch.", ""), i


def test_training_mode_unchanged(tiny):
    cfg, sd, _, x = tiny
    m, _ = _port(cfg, sd, act_store="fp8")
    m0, _ = _port(cfg, sd)
    torch.manual_seed(0)
    a = m.train()(_nchw(x))
    torch.manual_seed(0)
    b = m0.train()(_nchw(x))
    for u, v in zip(a[0], b[0]):
        assert torch.equal(u, v)
    assert torch.equal(a[1], b[1])


def test_int8_and_act_store_exclude_each_other(tiny):
    cfg = tiny[0]
    with pytest.raises(ValueError, match="mutually exclusive"):
        build_model(cfg, quant=Q.QuantCfg(mode="calib"), act_store="fp8")
    from desenet_tpu_torch.cli import val as cli_val

    with pytest.raises(ValueError, match="mutually exclusive"):
        cli_val.run("unused.yaml", "unused.npz", int8=True, act_store="fp8",
                    device="cpu")


def _every_row_cfg(name):
    if name == "exotic":
        return copy.deepcopy(EXOTIC_CFG)
    with open(CFG) as fh:
        cfg = yaml.safe_load(fh)
    cfg["head"][-2] = [[16, 19, 22], 1, f"SegMask{name}", ["se_nc", 1, 256]]
    return cfg


# the rows whose JAX block leaves its output in the compute dtype
_UNSTORED = {"CrossConv", "MixConv2d", "BatchNorm"}


def _leaf(rng, name: str, shape) -> np.ndarray:
    """A variable: kernels N(0, 1.3 / sqrt(fan_in)) for convs and
    N(0, 1 / sqrt(fan_in)) otherwise, BN at identity, biases 0."""
    if name == "kernel":
        fan = np.prod(shape[:-1])
        std = (1.3 if len(shape) == 4 else 1.0) / np.sqrt(fan)
        return rng.normal(0, std, shape).astype(np.float32)
    return (np.ones if name in ("scale", "var") else np.zeros)(
        shape, np.float32)


@pytest.mark.parametrize("name", ["exotic", "BiSe", "Lab", "Base"])
def test_act_store_every_row_matches_jax(name):
    cfg = _every_row_cfg(name)
    rng = np.random.default_rng(0)
    with jax.enable_x64(True):
        jm, jspec = jax_build_model(cfg, act_store="fp8", dtype=jnp.float64)
        shapes = jax.eval_shape(
            lambda v: jm.init({"params": jax.random.PRNGKey(0),
                               "dropout": jax.random.PRNGKey(0)}, v,
                              train=False),
            jax.ShapeDtypeStruct((1, 64, 64, 3), np.float64))
        flat = {k: _leaf(rng, k[-1], s.shape) for k, s in
                traverse_util.flatten_dict(shapes).items()}
        x = rng.uniform(0, 1, (2, 64, 64, 3))
        (_, jfeats), jseg = jax.jit(lambda v, a: jm.apply(
            v, a, train=False))(traverse_util.unflatten_dict(flat),
                                jnp.asarray(x))
        jfeats = [np.asarray(f) for f in jfeats]
        jseg = None if jseg is None else np.asarray(jseg)
    sd, _ = state_dict_from_jax({"/".join(k): v for k, v in flat.items()},
                                jspec)
    m, spec = _port(cfg, sd, act_store="fp8")
    m0, _ = _port(cfg, sd)
    m.double(), m0.double()
    rows, run = {}, m._row

    def record(ls, mod, inp, cd, qmode):
        rows[ls.i] = out = run(ls, mod, inp, cd, qmode)
        return out

    m._row = record
    with torch.no_grad():
        (_, feats), seg = m(_nchw(x))
        (_, feats0), seg0 = m0(_nchw(x))
    pairs = list(zip(feats, jfeats, feats0))
    if spec.seg_layer >= 0:
        pairs.append((seg, jseg.transpose(0, 3, 1, 2), seg0))
    for got, want, plain in pairs:
        atol = 1e-5 * np.abs(want).max()
        np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=atol)
        assert np.abs(plain.numpy() - want).max() > 10 * atol
    fp_rows = det_fp_layers(spec, 1)
    for ls in spec.layers:
        if ls.name in ("Upsample", "Concat", "Detect") or ls.name in (
                "SegMaskBiSe", "SegMaskLab", "SegMaskBase"):
            continue
        stored = ls.name not in _UNSTORED and ls.i not in fp_rows
        want = torch.float8_e4m3fn if stored else torch.float64
        assert rows[ls.i].dtype == want, (ls.i, ls.name, rows[ls.i].dtype)
