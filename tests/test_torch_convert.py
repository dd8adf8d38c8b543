"""JAX variables -> port state dict: keys, shapes, layouts, and the bundled
JSON config.

Variable shapes come from ``jax.eval_shape`` of the JAX init (no compile);
every fused and unfused JAX layout must map onto exactly the port model's
state-dict keys, less the BNs that never run.
"""

import json
import os

import jax
import numpy as np
import pytest
import torch
import yaml
from flax import traverse_util

from desenet_tpu.models import build_model as jax_build_model
from desenet_tpu.models import config_path as jax_config_path
from desenet_tpu.utils.checkpoint import (migrate_focus_params,
                                          migrate_unfused_c3)
from desenet_tpu.utils.torch_convert import _focus_kernel_to_conv
from desenet_tpu_torch.models import build_model, config_path, init_weights
from desenet_tpu_torch.models.build import parse_config
from desenet_tpu_torch.utils.convert import (
    _conv_kernel_to_focus,
    load_npz_state_dict,
    load_state_dict,
    state_dict_from_jax,
)

HERE = os.path.dirname(os.path.abspath(__file__))


def jax_flat_shapes(cfg, **kw):
    model, _ = jax_build_model(cfg, **kw)
    x = jax.ShapeDtypeStruct((1, 64, 64, 3), np.float32)
    shapes = jax.eval_shape(
        lambda v: model.init({"params": jax.random.PRNGKey(0),
                              "dropout": jax.random.PRNGKey(0)}, v,
                             train=False), x)
    flat = traverse_util.flatten_dict(shapes, sep="/")
    rng = np.random.default_rng(0)
    return {k: rng.normal(size=s.shape).astype(np.float32)
            for k, s in flat.items()}


@pytest.mark.parametrize("cfg_name", ["tiny_psp2", "yolov5s_seg"])
@pytest.mark.parametrize("layout", [
    dict(),  # the JAX package's default: fused stem + fused C3
    dict(fuse_focus=False, fused_csp=False),  # the reference layout
])
def test_keys_and_shapes_cover_the_model(cfg_name, layout):
    path = (os.path.join(HERE, "configs", "tiny_psp2.yaml")
            if cfg_name == "tiny_psp2" else jax_config_path(cfg_name))
    with open(path) as fh:
        cfg = yaml.safe_load(fh)
    flat = jax_flat_shapes(cfg, **layout)
    model, spec = build_model(cfg)
    sd, unfilled = state_dict_from_jax(flat, spec)
    expected = model.state_dict()
    assert unfilled == model.quirk_bn_keys()
    assert sorted(set(sd) | set(unfilled)) == sorted(expected)
    for k, v in sd.items():
        assert v.shape == expected[k].shape, k
    # the two quirk BNs of the shipped head, nothing else
    assert {k.rsplit(".bn.", 1)[0] for k in unfilled} == {
        "model.24.spatial_path.branch_global.1",
        "model.24.context_path.1.conv1"}


def test_fused_and_unfused_layouts_give_the_same_state_dict():
    """The JAX package's fused stem and fused C3 (made from the reference
    layout by its own checkpoint migrations) convert to the same torch
    tensors as the reference layout."""
    with open(os.path.join(HERE, "configs", "tiny_psp2.yaml")) as fh:
        cfg = yaml.safe_load(fh)
    unfused = jax_flat_shapes(cfg, fuse_focus=False, fused_csp=False)
    model, spec = build_model(cfg)
    sd_u, _ = state_dict_from_jax(unfused, spec)
    tree = traverse_util.unflatten_dict(unfused, sep="/")
    fused = traverse_util.flatten_dict(
        migrate_unfused_c3(migrate_focus_params(tree)), sep="/")
    assert any("/cv12/" in k for k in fused)
    assert "params/l0/conv/conv2d/kernel" in fused
    sd_f, _ = state_dict_from_jax(fused, spec)
    assert sorted(sd_f) == sorted(sd_u)
    for k in sd_u:
        torch.testing.assert_close(sd_f[k], sd_u[k], rtol=0, atol=0)


def test_focus_kernel_roundtrip():
    w = np.random.default_rng(0).normal(size=(8, 12, 3, 3)).astype(np.float32)
    np.testing.assert_array_equal(_conv_kernel_to_focus(
        _focus_kernel_to_conv(w)), w)


def test_npz_state_dict_roundtrip(tmp_path):
    with open(os.path.join(HERE, "configs", "tiny_psp2.yaml")) as fh:
        cfg = yaml.safe_load(fh)
    model, _ = build_model(cfg)
    init_weights(model, torch.Generator().manual_seed(0))
    # what tools/export_torch_sd.py writes: no quirk BNs, no step counters
    quirk = set(model.quirk_bn_keys())
    sd = {k: v.numpy() for k, v in model.state_dict().items()
          if k not in quirk and not k.endswith("num_batches_tracked")}
    np.savez(tmp_path / "sd.npz", **sd)
    model2, _ = build_model(cfg)
    load_state_dict(model2, load_npz_state_dict(tmp_path / "sd.npz"))
    x = torch.rand(1, 3, 64, 64, generator=torch.Generator().manual_seed(1))
    with torch.no_grad():
        (d1, _), s1 = model(x)
        (d2, _), s2 = model2(x)
    torch.testing.assert_close(d1, d2, rtol=0, atol=0)
    torch.testing.assert_close(s1, s2, rtol=0, atol=0)
    with pytest.raises(KeyError):
        load_state_dict(model2, {k: torch.from_numpy(v)
                                 for k, v in list(sd.items())[1:]})


@pytest.mark.parametrize("name", ["yolov5s_seg", "yolov5m_seg",
                                  "yolov5l_seg", "yolov5s"])
def test_bundled_json_equals_yaml(name):
    with open(config_path(name)) as fh:
        bundled = json.load(fh)
    with open(jax_config_path(name)) as fh:
        assert bundled == yaml.safe_load(fh)


def test_init_weights_is_seeded():
    cfg = config_path("yolov5s_seg")
    a = init_weights(build_model(cfg)[0], torch.Generator().manual_seed(0))
    b = init_weights(build_model(cfg)[0], torch.Generator().manual_seed(0))
    sa, sb = a.state_dict(), b.state_dict()
    assert all(torch.equal(sa[k], sb[k]) for k in sa)
    assert sum(p.numel() for p in a.parameters()) == 7594268
    # Detect prior: obj bias shifted by log(8 / (640 / 8)^2) at P3
    obj = a.model[25].m[0].bias.detach().view(3, 11)[:, 4]
    assert float(obj.max()) < np.log(8 / 80 ** 2) + 1 / np.sqrt(128)


@pytest.mark.parametrize("row,exc", [
    # the JAX package runs nearest upsampling only
    ([-1, 1, "nn.Upsample", [None, 2, "bilinear"]], NotImplementedError),
    # the blocks the DSL cannot name are unknown rows in both packages
    ([-1, 1, "ARM", [64]], ValueError),
    ([-1, 1, "NoSuchBlock", [64]], ValueError),
])
def test_unported_rows_raise(row, exc):
    with open(config_path("yolov5s_seg")) as fh:
        cfg = json.load(fh)
    cfg["backbone"] = cfg["backbone"][:1] + [row] + cfg["backbone"][2:]
    with pytest.raises(exc, match="not ported" if exc is NotImplementedError
                       else "unknown"):
        parse_config(cfg)


@pytest.mark.parametrize("row", [[-1, 1, "DWConv", [64, 3]],
                                 [-1, 1, "C3TR", [64]]])
def test_formerly_unported_rows_build(row):
    """The rows test_unported_rows_raise listed before every DSL row was
    ported."""
    with open(config_path("yolov5s_seg")) as fh:
        cfg = json.load(fh)
    cfg["backbone"] = cfg["backbone"][:1] + [row] + cfg["backbone"][2:]
    spec = parse_config(cfg)
    assert spec.layers[1].name == row[2]
