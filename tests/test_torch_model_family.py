"""Every model the JAX package's DSL builds, in desenet_tpu_torch, on the CPU.

(a) The reference goldens of the PSP, Lab and Base heads (tiny configs, 64
    px) load their torch state dicts straight into the port, stemmed both
    ways (Focus, and FusedFocus with the Focus weights rearranged at load),
    and match the reference's ``dec``, ``feat0-2`` and ``seg`` at atol 2e-5,
    the bar tests/test_model_parity.py holds the JAX model to; the BiSe
    head golden likewise, standalone.
(b) The port's ModelSpec equals the JAX package's for every config: the
    four bundled ones, the tiny ones, BiSe and EXOTIC_CFG, both stems, and
    the port's P6 ``yolov5x6_seg`` (which the JAX package does not ship:
    its parser takes the port's JSON). So
    the row arguments agree, ``n`` on the seg heads included (SegMaskPSP2
    ignores it in both packages, ASPP's map_reduce = 5 - n and Base's C3
    take it).
(c) FusedFocus equals Focus on the same weights (f32, atol 2e-5 for the
    stem alone, 1e-4 for a whole model, the JAX-forward bar), and the
    port's Focus -> fused rearrangement equals the JAX package's.
(d) Training-mode forwards of the BiSe and Base tiny models against the
    JAX package's, in float64, without dropout: the tensor that enters the
    dropout (flax ``capture_intermediates``), BiSe's aux outputs and the
    detection features at atol 1e-4, the BN running statistics at 1e-5;
    the dropout itself by its rate and its 1/(1-p) scale, in both
    packages, as their bits cannot agree.
(e) The served program on every non-PSP2 head against the JAX package's
    (the 1/8 logits through the JAX seg tail); ``yolov5x6_seg`` at width
    0.125 (four levels to stride 64) against the JAX package's forward on
    its init: the decode, the levels' maps, the 1/8 seg logits and the
    served seg map; and the refusal of a model
    with no seg head (the bundled yolov5s) by Predictor, Validator and the
    training step.
"""

import dataclasses
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import linen as fnn
from flax import traverse_util

from desenet_tpu.models import build_model as jax_build_model
from desenet_tpu.models import init_model, parse_config as jax_parse_config
from desenet_tpu.ops.seg_pallas import upsample_argmax as jax_upsample_argmax
from desenet_tpu.utils.torch_convert import _focus_kernel_to_conv
from desenet_tpu_torch.api import Predictor
from desenet_tpu_torch.eval import Validator
from desenet_tpu_torch.losses import DetectionLoss
from desenet_tpu_torch.models import (build_model, config_path, init_weights,
                                      parse_config)
from desenet_tpu_torch.models.heads import SegMaskBiSe
from desenet_tpu_torch.models.layers import Dropout, Focus, FusedFocus
from desenet_tpu_torch.testing import randomize_bn
from desenet_tpu_torch.train import make_train_step, one_cycle
from desenet_tpu_torch.train.optim import OptimConfig
from desenet_tpu_torch.utils.convert import (focus_to_fused, load_state_dict,
                                             state_dict_from_jax)
from test_torch_model_parity import load_cfg, nchw

HERE = os.path.dirname(os.path.abspath(__file__))
GOLD = os.path.join(HERE, "goldens")


def load_golden(name):
    with np.load(os.path.join(GOLD, name)) as z:
        sd = {k[4:]: torch.from_numpy(z[k]) for k in z.files
              if k.startswith("sd__")}
        ref = {k: z[k] for k in z.files if not k.startswith("sd__")}
    return sd, ref


@pytest.mark.parametrize("fuse_focus", [False, True])
@pytest.mark.parametrize("head", ["psp", "lab", "base"])
def test_golden_heads(head, fuse_focus):
    sd, ref = load_golden(f"tiny_{head}.npz")
    model, spec = build_model(load_cfg(f"tiny_{head}"), fuse_focus=fuse_focus)
    assert spec.layers[24].name == {"psp": "SegMaskPSP", "lab": "SegMaskLab",
                                    "base": "SegMaskBase"}[head]
    load_state_dict(model, sd)
    with torch.no_grad():
        (dec, feats), seg = model(torch.from_numpy(ref["x"]))
    np.testing.assert_allclose(dec.numpy(), ref["dec"], atol=2e-5)
    for i in range(3):
        np.testing.assert_allclose(feats[i].numpy(), ref[f"feat{i}"],
                                   atol=2e-5)
    np.testing.assert_allclose(seg.numpy(), ref["seg"], atol=2e-5)


@pytest.mark.parametrize("upsample", [True, False])
def test_golden_bise_head(upsample):
    """SegMaskBiSe standalone (the reference cannot build it from a
    config), as tests/test_model_parity.py holds the JAX head; at 1/8 the
    logits' 8x upsample is held to the golden."""
    sd, ref = load_golden("head_bise.npz")
    head = SegMaskBiSe([32, 32, 64], n_segcls=2, c_hid=32,
                       upsample=upsample).eval()
    head.load_state_dict(sd)
    with torch.no_grad():
        seg = head([torch.from_numpy(ref[f"x{i}"]) for i in range(3)])
    if not upsample:
        assert seg.shape[2:] == (16, 16)
        seg = torch.nn.functional.interpolate(
            seg, scale_factor=8, mode="bilinear", align_corners=True)
    np.testing.assert_allclose(seg.numpy(), ref["seg"], atol=2e-5)


SPEC_CASES = ["yolov5s_seg", "yolov5m_seg", "yolov5l_seg", "yolov5s",
              "tiny_psp2", "tiny_psp", "tiny_lab", "tiny_base", "tiny_bise",
              "exotic", "yolov5x6_seg"]
# shipped by the port alone: the JAX package's parser takes the port's JSON
PORT_CONFIGS = ("yolov5x6_seg",)


def port_json(name: str) -> dict:
    with open(config_path(name)) as fh:
        return json.load(fh)


@pytest.mark.parametrize("name", SPEC_CASES)
def test_spec_matches_jax(name):
    cfg = load_cfg(name) if name.startswith("tiny") or name == "exotic" \
        else config_path(name)
    jcfg = port_json(name) if name in PORT_CONFIGS else load_cfg(name)
    for fuse in (False, True):
        got = parse_config(cfg, fuse_focus=fuse)
        want = jax_parse_config(jcfg, fuse_focus=fuse)
        assert dataclasses.astuple(got) == dataclasses.astuple(want)


def test_anchor_count_shorthand_matches_jax():
    """``anchors: N`` (N anchors a scale, placeholder sizes) parses as in
    the JAX package."""
    cfg = load_cfg("tiny_psp2")
    cfg["anchors"] = 2
    got = parse_config(cfg)
    want = jax_parse_config(cfg, fuse_focus=False)
    assert dataclasses.astuple(got) == dataclasses.astuple(want)
    assert got.anchors == ((0.0, 1.0, 2.0, 3.0),) * 3


def test_testing_configs_match_the_tests():
    """desenet_tpu_torch.testing's copies (chip_smoke.py runs them where
    neither JAX nor PyYAML is) equal the test configs."""
    from desenet_tpu_torch.testing import EXOTIC_CFG, tiny_head_cfg
    from test_exotic_blocks import EXOTIC_CFG as want

    assert EXOTIC_CFG == want
    for head, name in (("SegMaskPSP", "tiny_psp"), ("SegMaskLab", "tiny_lab"),
                       ("SegMaskBase", "tiny_base"),
                       ("SegMaskBiSe", "tiny_bise")):
        yml = load_cfg(name)
        for row in yml["head"]:  # the yaml's upsample rows say 'None'
            row[3] = [None if a == "None" else a for a in row[3]]
        assert tiny_head_cfg(head) == yml


def test_seg_head_depth_follows_jax():
    """m and l round the seg head's n to 2 and 3; SegMaskPSP2 ignores it,
    so its parameters do not depend on n."""
    for name, n in (("yolov5s_seg", 1), ("yolov5m_seg", 2),
                    ("yolov5l_seg", 3)):
        assert parse_config(config_path(name)).layers[24].args[1] == n
    cfg = load_cfg("tiny_psp2")
    sizes = []
    for n in (1, 9):
        cfg["head"][-2][3][1] = n
        model, spec = build_model(cfg)
        assert spec.layers[24].args[1] == (n if n == 1 else 3)
        sizes.append(sum(p.numel() for p in model.model[24].parameters()))
    assert sizes[0] == sizes[1]


@pytest.mark.parametrize("hw", [(64, 64), (40, 72)])
def test_fused_focus_equals_focus(hw):
    focus = randomize_bn(Focus(3, 16, 3), seed=1).eval()
    init_weights_like(focus, 0)
    fused = FusedFocus(3, 16).eval()
    fused.load_state_dict({k[len("model.0."):]: v for k, v in focus_to_fused(
        {f"model.0.{k}": v for k, v in focus.state_dict().items()},
        parse_config(load_cfg("tiny_psp2"), fuse_focus=True)).items()})
    x = torch.rand(2, 3, *hw, generator=torch.Generator().manual_seed(2))
    with torch.no_grad():
        torch.testing.assert_close(fused(x), focus(x), rtol=0, atol=2e-5)


def init_weights_like(mod, seed):
    g = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for p in mod.parameters():
            if p.dim() == 4:
                p.copy_(torch.empty(p.shape).uniform_(-0.3, 0.3, generator=g))


@pytest.mark.parametrize("name", ["tiny_psp2", "tiny_bise"])
def test_fused_model_equals_focus_model(name):
    cfg = load_cfg(name)
    model, _ = build_model(cfg)
    init_weights(model, torch.Generator().manual_seed(0))
    randomize_bn(model, seed=3)
    fused, spec = build_model(cfg, fuse_focus=True)
    load_state_dict(fused, model.state_dict())
    assert spec.layers[0].name == "FusedFocus"
    x = torch.rand(2, 3, 64, 64, generator=torch.Generator().manual_seed(4))
    with torch.no_grad():
        (d0, f0), s0 = model(x)
        (d1, f1), s1 = fused(x)
    for a, b in [(d1, d0), (s1, s0)] + list(zip(f1, f0)):
        torch.testing.assert_close(a, b, rtol=0, atol=1e-4)


def test_focus_rearrangement_matches_jax():
    w = torch.randn(32, 12, 3, 3, generator=torch.Generator().manual_seed(0))
    spec = parse_config(load_cfg("tiny_psp2"), fuse_focus=True)
    got = focus_to_fused({"model.0.conv.conv.weight": w,
                          "model.0.conv.bn.weight": torch.ones(32)}, spec)
    assert sorted(got) == ["model.0.bn.weight", "model.0.conv.weight"]
    want = np.transpose(_focus_kernel_to_conv(w.numpy()), (3, 2, 0, 1))
    np.testing.assert_array_equal(got["model.0.conv.weight"].numpy(), want)


def _train_variables(jmodel, x):
    """JAX variables made in training mode, so that BiSe's aux heads have
    them (the JAX package's eval-mode init makes none)."""
    return jax.device_get(jmodel.init(
        {"params": jax.random.PRNGKey(0), "dropout": jax.random.PRNGKey(1)},
        jnp.asarray(x), train=True))


@pytest.mark.parametrize("name,pre_dropout", [("tiny_bise", "ffm"),
                                              ("tiny_base", "c3spp")])
def test_train_forward_matches_jax_before_dropout(name, pre_dropout):
    """In float64 on both sides, as the training-step tests run: BN on
    batch statistics over 32 values a channel (1/16 maps, batch 2) moves
    f32 rounding of the two packages' convs up to 2e-3 apart."""
    with jax.enable_x64(True):
        _train_forward_case(name, pre_dropout)


def _train_forward_case(name, pre_dropout):
    cfg = load_cfg(name)
    x = np.random.default_rng(0).uniform(0, 1, (2, 64, 64, 3))
    jmodel, _ = jax_build_model(cfg, dtype=jnp.float64)
    variables = jax.tree.map(lambda a: np.asarray(a, np.float64),
                             _train_variables(jmodel, x))
    (jfeats, jseg), state = jmodel.apply(
        variables, jnp.asarray(x), train=True, rngs={"dropout":
                                                     jax.random.PRNGKey(2)},
        mutable=["batch_stats", "intermediates"],
        capture_intermediates=lambda m, _: m.name == pre_dropout)
    jpre = state["intermediates"]["l24"][pre_dropout]["__call__"][0]

    model, spec = build_model(cfg, train=True)
    sd, unfilled = state_dict_from_jax(
        traverse_util.flatten_dict(variables, sep="/"), spec)
    assert unfilled == model.quirk_bn_keys()
    load_state_dict(model.double(), sd)
    head = model.model[24]
    mod = head.out[0] if name == "tiny_bise" else head.m[1]
    seen = []
    hook = mod.register_forward_hook(lambda m, a, out: seen.append(out))
    try:
        with torch.no_grad():
            feats, seg = model(nchw(x))
    finally:
        hook.remove()
    np.testing.assert_allclose(seen[0].permute(0, 2, 3, 1).numpy(),
                               np.asarray(jpre), atol=1e-4)
    for f, jf in zip(feats, jfeats):
        np.testing.assert_allclose(f.numpy(), np.asarray(jf), atol=1e-4)
    if name == "tiny_bise":  # [out, aux16, aux32]; out went through dropout
        assert isinstance(seg, list) and len(seg) == 3
        for s, js in zip(seg[1:], jseg[1:]):
            assert s.shape[2:] == (64, 64)
            np.testing.assert_allclose(s.permute(0, 2, 3, 1).numpy(),
                                       np.asarray(js), atol=1e-4)
    else:
        assert seg.shape[2:] == (64, 64)
    # the running statistics moved alike
    stats = state_dict_from_jax(traverse_util.flatten_dict(
        {"batch_stats": state["batch_stats"]}, sep="/"), spec)[0]
    msd = model.state_dict()
    for k, v in stats.items():
        if k.endswith(("running_mean", "running_var")):
            np.testing.assert_allclose(msd[k].numpy(), v.numpy(), atol=1e-5,
                                       err_msg=k)


def test_dropout_rate_and_scale_match_flax():
    """Both packages zero about p of the elements and scale the rest by
    1/(1-p); the port's mask comes from the generator it is given."""
    p = 0.1
    x = torch.rand(64, 32, 16, 16, generator=torch.Generator().manual_seed(0))
    x += 0.5  # no zeros in the input
    drop = Dropout(p).train()
    outs = []
    for _ in range(2):
        drop.generator = torch.Generator().manual_seed(7)
        outs.append(drop(x))
    assert torch.equal(outs[0], outs[1])
    y = outs[0]
    jy = np.asarray(fnn.Dropout(p, deterministic=False).apply(
        {}, jnp.asarray(x.numpy()), rngs={"dropout": jax.random.PRNGKey(0)}))
    n = x.numel()
    for got in (y.numpy(), jy):
        zero = got == 0
        assert abs(zero.mean() - p) < 4 * np.sqrt(p * (1 - p) / n)
        np.testing.assert_allclose(got[~zero], x.numpy()[~zero] / (1 - p),
                                   rtol=1e-6)
    assert torch.equal(drop.eval()(x), x)


def _jax_and_port(name, fuse_focus):
    cfg = load_cfg(name)
    jmodel, _ = jax_build_model(cfg, seg_upsample=False)
    variables = jax.device_get(
        init_model(jmodel, jax.random.PRNGKey(0), img_size=64, batch=1))
    sd, _ = state_dict_from_jax(traverse_util.flatten_dict(variables, sep="/"),
                                parse_config(cfg))
    return cfg, jmodel, variables, sd


@pytest.mark.parametrize("name,fuse_focus", [
    ("tiny_psp", True), ("tiny_lab", True), ("tiny_base", False),
    ("tiny_bise", True)])
def test_served_seg_map_matches_jax(name, fuse_focus):
    """Predictor.infer (f32, CPU: K2's plain version) against the JAX
    served program's seg map: its model's 1/8 logits through the JAX seg
    tail (its plain path off the TPU)."""
    cfg, jmodel, variables, sd = _jax_and_port(name, fuse_focus)
    pred = Predictor(cfg, sd, imgsz=64, conf_thres=1e-3, half=False,
                     device="cpu", fuse_focus=fuse_focus)
    assert pred.spec.layers[0].name == ("FusedFocus" if fuse_focus
                                        else "Focus")
    imgs = np.random.default_rng(1).integers(0, 256, (3, 64, 64, 3),
                                             dtype=np.uint8)
    _, seg = pred.infer(torch.from_numpy(imgs))
    _, jseg = jmodel.apply(variables, jnp.asarray(imgs, jnp.float32) / 255.0,
                           train=False)
    want = np.asarray(jax_upsample_argmax(jseg, scale=8, align_corners=True))
    assert seg.shape == (3, 64, 64) and seg.dtype == torch.uint8
    assert float((seg.numpy() == want).mean()) >= 0.999


def test_p6_forward_matches_jax():
    """yolov5x6_seg at width 0.125 (every depth as shipped) at 128 px, the
    JAX package's init loaded into the port: the eval forward's decode of
    every anchor, the four levels' maps and the 1/8 seg logits (f32, the
    bar of (a)), and the served seg map."""
    cfg = port_json("yolov5x6_seg")
    cfg["width_multiple"] = 0.125
    jmodel, _ = jax_build_model(cfg, seg_upsample=False)
    x0 = jnp.zeros((1, 128, 128, 3))
    variables = jax.device_get(jax.jit(lambda k: jmodel.init(
        {"params": k, "dropout": k}, x0, train=False))(
            jax.random.PRNGKey(0)))
    sd, _ = state_dict_from_jax(traverse_util.flatten_dict(variables, sep="/"),
                                parse_config(cfg))
    model, spec = build_model(cfg, seg_upsample=False)
    load_state_dict(model, sd)
    assert spec.det_strides == (8, 16, 32, 64)
    imgs = np.random.default_rng(1).integers(0, 256, (2, 128, 128, 3),
                                             dtype=np.uint8)
    (jdec, jfeats), jseg = jax.jit(lambda v, x: jmodel.apply(
        v, x, train=False))(variables, jnp.asarray(imgs, jnp.float32) / 255.0)
    with torch.no_grad():
        (dec, feats), seg = model.eval()(nchw(imgs.astype(np.float32) / 255.0))
    assert dec.shape == (2, 3 * (16 ** 2 + 8 ** 2 + 4 ** 2 + 2 ** 2), 11)
    np.testing.assert_allclose(dec.numpy(), np.asarray(jdec), rtol=1e-6,
                               atol=2e-5)
    assert len(feats) == len(jfeats) == 4
    for f, jf in zip(feats, jfeats):
        np.testing.assert_allclose(f.numpy(), np.asarray(jf), atol=2e-5)
    np.testing.assert_allclose(seg.numpy(), np.asarray(nchw(np.asarray(jseg))),
                               atol=2e-5)
    pred = Predictor(cfg, sd, imgsz=128, conf_thres=1e-3, half=False,
                     device="cpu")
    _, smap = pred.infer(torch.from_numpy(imgs))
    want = np.asarray(jax_upsample_argmax(jseg, scale=8, align_corners=True))
    assert float((smap.numpy() == want).mean()) >= 0.999


def test_seg_head_fused_is_psp2_only():
    """seg_head_fused (kernel K4) takes only SegMaskPSP2; another head runs
    its module graph as the JAX package's walker does."""
    cfg = load_cfg("tiny_lab")
    a, _ = build_model(cfg)
    init_weights(a, torch.Generator().manual_seed(0))
    b, _ = build_model(cfg, seg_head_fused=True)
    b.load_state_dict(a.state_dict())
    x = torch.rand(1, 3, 64, 64, generator=torch.Generator().manual_seed(1))
    with torch.no_grad():
        assert torch.equal(a(x)[1], b(x)[1])


@pytest.mark.parametrize("what", ["Predictor", "Validator",
                                  "make_train_step"])
def test_no_seg_head_is_refused(what):
    """The bundled yolov5s has no seg head; the JAX package's programs all
    take the seg output, so the port refuses it where it is built."""
    cfg = config_path("yolov5s")
    model, spec = build_model(cfg, seg_upsample=what != "make_train_step",
                              train=what == "make_train_step")
    assert spec.seg_layer == -1 and spec.se_nc == 0
    with pytest.raises(ValueError, match="seg head"):
        if what == "Predictor":
            Predictor(cfg, model.state_dict(), device="cpu", half=False)
        elif what == "Validator":
            Validator(model, nc=80, se_nc=0)
        else:
            make_train_step(model, DetectionLoss(
                anchors=model.model[spec.det_layer].anchors_grid_units(),
                nc=80), OptimConfig(), one_cycle(1, 0.2, 10), nb=1,
                warmup_iters=1, fused_seg=True)
