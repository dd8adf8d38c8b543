"""desenet_tpu_torch model vs the reference goldens and vs the JAX model.

(a) The tiny_psp2 golden's torch state dict loads straight into the port,
    whose forward must match the reference outputs at atol 2e-5 (the bar
    tests/test_model_parity.py holds the JAX model to); the other heads'
    goldens are in test_torch_model_family.py.
(b) JAX variables from ``init_model`` pass through ``state_dict_from_jax``;
    the port and the JAX model then see the same input, f32 on the CPU,
    atol 1e-4 (different conv/reduction orders on the CPU; outputs are
    pixel coordinates up to 640): every seg head (the tiny configs, and
    SegMaskBiSe on tiny_psp2's graph), every DSL row (tests/
    test_exotic_blocks.py's EXOTIC_CFG) and the four bundled configs, with
    the port's stem as Focus (the JAX fused stem's kernel inverted) and as
    FusedFocus (taken as it is).
"""

import os

import jax
import numpy as np
import pytest
import torch
import yaml
from flax import traverse_util

from desenet_tpu.models import build_model as jax_build_model
from desenet_tpu.models import config_path as jax_config_path
from desenet_tpu.models import init_model
from desenet_tpu_torch.models import build_model
from desenet_tpu_torch.utils.convert import load_state_dict, state_dict_from_jax

HERE = os.path.dirname(os.path.abspath(__file__))


def load_cfg(name):
    if name == "exotic":
        from test_exotic_blocks import EXOTIC_CFG

        return dict(EXOTIC_CFG)
    if name == "tiny_bise":  # the reference cannot name BiSe in a config
        cfg = load_cfg("tiny_psp2")
        cfg["head"][-2] = [[16, 19, 22], 1, "SegMaskBiSe", ["se_nc", 1, 256]]
        return cfg
    path = (os.path.join(HERE, "configs", f"{name}.yaml") if name.startswith(
        "tiny") else jax_config_path(name))
    with open(path) as fh:
        return yaml.safe_load(fh)


def nchw(x):
    return torch.from_numpy(np.ascontiguousarray(np.transpose(x, (0, 3, 1, 2))))


def test_golden_tiny_psp2():
    with np.load(os.path.join(HERE, "goldens", "tiny_psp2.npz")) as z:
        sd = {k[4:]: torch.from_numpy(z[k]) for k in z.files
              if k.startswith("sd__")}
        ref = {k: z[k] for k in z.files if not k.startswith("sd__")}
    model, _ = build_model(load_cfg("tiny_psp2"), seg_upsample=True)
    load_state_dict(model, sd)
    with torch.no_grad():
        (dec, feats), seg = model(torch.from_numpy(ref["x"]))
    np.testing.assert_allclose(dec.numpy(), ref["dec"], atol=2e-5)
    for i in range(3):
        np.testing.assert_allclose(feats[i].numpy(), ref[f"feat{i}"],
                                   atol=2e-5)
    np.testing.assert_allclose(seg.numpy(), ref["seg"], atol=2e-5)


@pytest.mark.parametrize("name,seg_upsample,fuse_focus", [
    ("tiny_psp2", True, False),
    ("yolov5s_seg", False, False),
    ("tiny_psp2", False, True),
    ("tiny_psp", True, False),
    ("tiny_psp", False, True),
    ("tiny_lab", True, True),
    ("tiny_lab", False, False),
    ("tiny_base", True, False),
    ("tiny_base", False, True),
    ("tiny_bise", True, True),
    ("tiny_bise", False, False),
    ("exotic", True, False),
    ("exotic", True, True),
    ("yolov5s_seg", False, True),
    ("yolov5m_seg", False, True),
    ("yolov5l_seg", False, True),
    ("yolov5s", True, True),
])
def test_jax_weights_match_jax_forward(name, seg_upsample, fuse_focus):
    cfg = load_cfg(name)
    jmodel, _ = jax_build_model(cfg, seg_upsample=seg_upsample)
    variables = jax.device_get(
        init_model(jmodel, jax.random.PRNGKey(0), img_size=64, batch=1))
    flat = traverse_util.flatten_dict(variables, sep="/")

    model, spec = build_model(cfg, seg_upsample=seg_upsample,
                              fuse_focus=fuse_focus)
    assert spec.layers[0].name == ("FusedFocus" if fuse_focus else "Focus")
    sd, unfilled = state_dict_from_jax(flat, spec)
    # JAX's eval init makes no variables for BiSe's training-only aux heads
    assert unfilled == sorted(model.quirk_bn_keys()
                              + model.train_only_keys())
    assert all(".aux" in k for k in model.train_only_keys())
    load_state_dict(model, sd)

    b = 2 if name.startswith("tiny") or name == "exotic" else 1
    x = np.random.default_rng(0).uniform(0, 1, (b, 64, 64, 3)).astype(
        np.float32)
    (jdec, jfeats), jseg = jmodel.apply(variables, x, train=False)
    with torch.no_grad():
        (dec, feats), seg = model(nchw(x))
    np.testing.assert_allclose(dec.numpy(), np.asarray(jdec), atol=1e-4)
    for f, jf in zip(feats, jfeats):
        np.testing.assert_allclose(f.numpy(), np.asarray(jf), atol=1e-4)
    if spec.seg_layer < 0:
        assert seg is None and jseg is None
        return
    assert seg.shape[2:] == ((64, 64) if seg_upsample else (8, 8))
    np.testing.assert_allclose(seg.permute(0, 2, 3, 1).numpy(),
                               np.asarray(jseg), atol=1e-4)
