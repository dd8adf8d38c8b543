"""The fused eval SegMaskPSP2 head, JAX vs port, on the CPU.

The JAX head is initialised with flax and given random BN statistics (so
the fold is exercised); its variables are carried into the port's
``SegMaskPSP2`` module by ``utils/convert``'s name table. Then:
(a) the port's ``fused_psp2_eval`` (its plain body on a CPU tensor) against
    the JAX ``fused_psp2_eval`` with Pallas in interpret mode, f32,
    rtol/atol 1e-4 (the bar the JAX kernel is held to against its module);
(b) the same against the port's own module head, f32, rtol/atol 1e-4;
(c) bf16: logits within rtol 0.1 / atol 0.15 of the JAX kernel's and class
    decisions equal on more than 99% of positions
    (tests/test_seg_head_pallas.py's bf16 bar);
(d) the tiny_psp2 model built with ``seg_head_fused=True`` and
    ``decode_cat=False`` against the JAX model forward, atol 1e-4.
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
from desenet_tpu.models import heads as jax_heads
from desenet_tpu.models import init_model
from desenet_tpu.ops.seg_head_pallas import fused_psp2_eval as jax_fused
from desenet_tpu_torch.models import build as port_build
from desenet_tpu_torch.models import build_model
from desenet_tpu_torch.models.build import LayerSpec, ModelSpec
from desenet_tpu_torch.models.heads import SegMaskPSP2
from desenet_tpu_torch.ops import seg_head_pallas
from desenet_tpu_torch.utils.convert import (flax_path_to_torch_key,
                                             load_state_dict,
                                             state_dict_from_jax,
                                             to_torch_tensor)

HERE = os.path.dirname(os.path.abspath(__file__))
N_SEG = 3


def make_inputs(rng, b=2, h8=16, w8=16, c16=128):
    return [rng.normal(size=(b, h8, w8, c16)).astype(np.float32),
            rng.normal(size=(b, h8 // 2, w8 // 2, 2 * c16)).astype(np.float32),
            rng.normal(size=(b, h8 // 4, w8 // 4, 4 * c16)).astype(np.float32)]


def randomize_stats(v, rng):
    bs = jax.tree_util.tree_map(
        lambda leaf: jnp.asarray(np.abs(rng.normal(size=leaf.shape)).astype(
            np.float32) + 0.5), v["batch_stats"])
    return {"params": v["params"], "batch_stats": bs}


def jax_head(xs, rng, c_hid=128, dtype=jnp.float32):
    head = jax_heads.SegMaskPSP2(n_segcls=N_SEG, c_hid=c_hid, dtype=dtype,
                                 upsample=False)
    v = head.init(jax.random.PRNGKey(0), [jnp.asarray(x) for x in xs],
                  train=False)
    return head, randomize_stats(v, rng)


def port_head(v, xs, c_hid):
    """The JAX head's variables in the port's module (one-row spec)."""
    spec = ModelSpec(layers=(LayerSpec(0, (-1,), "SegMaskPSP2",
                                       (N_SEG, 1, c_hid, False), N_SEG, 8),),
                     save=(), de_nc=1, se_nc=N_SEG, anchors=(),
                     det_strides=(), det_layer=-1, seg_layer=0)
    sd = {}
    for key, val in traverse_util.flatten_dict(v, sep="/").items():
        _, *path = key.split("/")
        k = flax_path_to_torch_key(("l0", *path), spec)
        sd[k[len("model.0."):]] = torch.from_numpy(np.array(
            to_torch_tensor(np.asarray(val, np.float32), path[-1])))
    head = SegMaskPSP2([x.shape[-1] for x in xs], n_segcls=N_SEG,
                       c_hid=c_hid, upsample=False)
    res = head.load_state_dict(sd, strict=False)
    assert not res.unexpected_keys
    assert all(".bn." in k for k in res.missing_keys), res.missing_keys
    return head.eval()


def nhwc(xs, dtype=torch.float32):
    return [torch.from_numpy(x).to(dtype) for x in xs]


@pytest.mark.parametrize("b,hw,c_hid", [(2, (16, 16), 128),
                                        (2, (16, 24), 128),
                                        (1, (8, 16), 192),
                                        (1, (8, 16), 256)])
def test_fused_head_matches_jax_kernel_and_module(b, hw, c_hid):
    rng = np.random.default_rng(c_hid + hw[1])
    xs = make_inputs(rng, b=b, h8=hw[0], w8=hw[1], c16=c_hid)
    head, v = jax_head(xs, rng, c_hid)
    want = np.asarray(jax_fused([jnp.asarray(x) for x in xs], v["params"],
                                v["batch_stats"], N_SEG, interpret=True))
    ported = port_head(v, xs, c_hid)
    got = seg_head_pallas.fused_psp2_eval(nhwc(xs), ported, N_SEG)
    assert got.shape == (b, *hw, N_SEG) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-4, atol=1e-4)
    with torch.no_grad():
        module = ported([torch.from_numpy(x).permute(0, 3, 1, 2)
                         for x in xs]).permute(0, 2, 3, 1)
    np.testing.assert_allclose(got.numpy(), module.numpy(), rtol=1e-4,
                               atol=1e-4)


def test_fused_head_bf16_tolerance():
    rng = np.random.default_rng(1)
    xs = make_inputs(rng)
    head, v = jax_head(xs, rng, dtype=jnp.bfloat16)
    want = np.asarray(jax_fused([jnp.asarray(x, jnp.bfloat16) for x in xs],
                                v["params"], v["batch_stats"], N_SEG,
                                interpret=True), np.float32)
    ported = port_head(v, xs, 128)
    got = seg_head_pallas.fused_psp2_eval(nhwc(xs, torch.bfloat16), ported,
                                          N_SEG).numpy()
    np.testing.assert_allclose(got, want, rtol=0.1, atol=0.15)
    agree = (got.argmax(-1) == want.argmax(-1)).mean()
    assert agree > 0.99, agree


def test_fused_head_refuses_what_it_does_not_take():
    rng = np.random.default_rng(2)
    xs = make_inputs(rng, b=1, h8=8, w8=8)
    head = SegMaskPSP2([128, 256, 512], n_segcls=N_SEG, c_hid=128,
                       upsample=False).eval()
    with pytest.raises(TypeError, match="float32 or bfloat16"):
        seg_head_pallas.fused_psp2_eval(nhwc(xs, torch.float64), head, N_SEG)
    with pytest.raises(ValueError, match="CPU or CUDA"):
        seg_head_pallas.fused_psp2_eval([x.to("meta") for x in nhwc(xs)],
                                        head, N_SEG)


def tiny_cfg():
    with open(os.path.join(HERE, "configs", "tiny_psp2.yaml")) as fh:
        return yaml.safe_load(fh)


def test_model_with_fused_head_matches_jax_forward():
    cfg = tiny_cfg()
    jmodel, _ = jax_build_model(cfg, seg_upsample=True)
    variables = jax.device_get(
        init_model(jmodel, jax.random.PRNGKey(0), img_size=64, batch=1))
    variables = randomize_stats(variables, np.random.default_rng(3))
    model, spec = build_model(cfg, decode_cat=False, seg_head_fused=True)
    sd, _ = state_dict_from_jax(traverse_util.flatten_dict(variables,
                                                           sep="/"), spec)
    load_state_dict(model, sd)

    x = np.random.default_rng(4).uniform(0, 1, (2, 64, 64, 3)).astype(
        np.float32)
    (jdec, _), jseg = jmodel.apply(variables, x, train=False)
    with torch.no_grad():
        (dec, _), seg = model(torch.from_numpy(x).permute(0, 3, 1, 2)
                              .contiguous())
    assert isinstance(dec, list) and len(dec) == 3
    np.testing.assert_allclose(torch.cat(dec, 1).numpy(), np.asarray(jdec),
                               atol=1e-4)
    assert seg.shape == (2, N_SEG - 1, 64, 64)  # tiny_psp2: se_nc 2
    np.testing.assert_allclose(seg.permute(0, 2, 3, 1).numpy(),
                               np.asarray(jseg), atol=1e-4)


def test_fused_route_only_in_eval_and_under_max_p8(monkeypatch):
    calls = []
    real = port_build.fused_psp2_eval

    def spy(*a, **k):
        calls.append(1)
        return real(*a, **k)

    monkeypatch.setattr(port_build, "fused_psp2_eval", spy)
    model, _ = build_model(tiny_cfg(), seg_upsample=False,
                           seg_head_fused=True)
    x = torch.rand((1, 3, 64, 64), generator=torch.Generator().manual_seed(0))
    with torch.no_grad():
        _, fused = model(x)
        assert len(calls) == 1
        monkeypatch.setattr(port_build, "MAX_P8", 63)  # 8 x 8 = 64 > 63
        _, module = model(x)
        assert len(calls) == 1
        model.train()
        model(x)
        assert len(calls) == 1
    assert fused.shape == module.shape == (1, 2, 8, 8)
    np.testing.assert_allclose(fused.numpy(), module.numpy(), atol=1e-4)


def test_ctypes_signatures_match_the_kernel_sources():
    """Every C entry point in csrc/ has its argument list registered in
    ops/_ext.py, pointer for pointer and number for number: ctypes passes an
    undeclared argument as a 32-bit int and would cut a pointer."""
    import ctypes
    import re

    from desenet_tpu_torch.ops import _ext

    found = {}
    for name in os.listdir(_ext.CSRC):
        if name.endswith(".cu"):
            with open(os.path.join(_ext.CSRC, name)) as fh:
                src = fh.read()
            for fn, args in re.findall(r'extern "C" int (\w+)\(([^)]*)\)', src):
                found[fn] = [a.strip() for a in args.split(",")]
    assert set(found) == set(_ext._SIGNATURES)
    for fn, args in found.items():
        sig = _ext._SIGNATURES[fn]
        assert len(sig) == len(args), fn
        for a, t in zip(args, sig):
            want = (ctypes.c_void_p if "*" in a else
                    ctypes.c_float if a.startswith("float") else ctypes.c_int)
            assert t is want, (fn, a)


def test_folded_weights_are_kept_until_the_head_changes():
    """The BN fold is cached per head; an in-place update of a statistic, a
    ``load_state_dict`` and a new dtype each give a fresh fold."""
    from desenet_tpu_torch.testing import psp2_inputs, random_psp2_head

    chans = (32, 64, 96)
    head = random_psp2_head(chans, 48)
    xs = psp2_inputs(1, 8, 8, chans)
    first = seg_head_pallas.fused_psp2_eval(xs, head, 3)
    w = seg_head_pallas._folded_weights(head, torch.float32, xs[0].device)
    assert seg_head_pallas._folded_weights(head, torch.float32,
                                           xs[0].device) is w
    assert torch.equal(seg_head_pallas.fused_psp2_eval(xs, head, 3), first)
    with torch.no_grad():
        head.m8[0].bn.running_var.mul_(4.0)
    changed = seg_head_pallas.fused_psp2_eval(xs, head, 3)
    assert not torch.allclose(changed, first)
    fresh = random_psp2_head(chans, 48)
    fresh.load_state_dict(head.state_dict())
    assert torch.equal(seg_head_pallas.fused_psp2_eval(xs, fresh, 3), changed)
    head.load_state_dict(random_psp2_head(chans, 48).state_dict())
    assert torch.equal(seg_head_pallas.fused_psp2_eval(xs, head, 3), first)
    assert seg_head_pallas._folded_weights(
        head, torch.bfloat16, xs[0].device)["m8"].dtype == torch.bfloat16
