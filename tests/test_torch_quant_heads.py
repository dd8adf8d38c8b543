"""The int8 program with the other seg heads, JAX vs the port, on the CPU.

tests/test_torch_quant.py holds the shipped SegMaskPSP2 graph; here the
tiny configs of the other heads go through both packages on the same
boosted weights (``testing.boosted_state``) and input: SegMaskPSP, which
has an int8 path of its own (RFB2, PyramidPooling with its shortcut, FFM
without a concat, the int8 class conv), and SegMaskLab and SegMaskBase,
which the int8 graph feeds dequantized maps. Per-channel calibration
gives JAX's site keys; on JAX's scales the decode and the seg logits are
within 2% of their largest magnitude and the seg class map equal on at
least 99% of the pixels, as for the shipped head.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import yaml

from desenet_tpu import quant as JQ
from desenet_tpu.models import build_model as jax_build_model
from desenet_tpu.utils.torch_convert import convert_state_dict
from desenet_tpu_torch import quant as Q
from desenet_tpu_torch.models import build_model
from desenet_tpu_torch.testing import boosted_state
from desenet_tpu_torch.utils.convert import load_state_dict


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.mark.parametrize("name", ["tiny_psp", "tiny_lab", "tiny_base"])
def test_int8_model_with_other_heads_matches_jax(name):
    with open(f"tests/configs/{name}.yaml") as fh:
        cfg = yaml.safe_load(fh)
    sd = boosted_state(build_model(cfg)[0], seed=0)
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
    xt = torch.from_numpy(np.array(x.transpose(0, 3, 1, 2)))

    cm, _ = jax_build_model(cfg, quant=JQ.QuantCfg(mode="calib",
                                                   per_channel_act=True))
    jscales, jmeans = JQ.calibrate_stats(cm, variables, [jnp.asarray(x)])
    pm, _ = build_model(cfg, fuse_focus=True, quant=Q.QuantCfg(
        mode="calib", per_channel_act=True))
    load_state_dict(pm, sd)
    pscales, _ = Q.calibrate_stats(pm.eval(), [xt])
    assert [k for k, _ in pscales] == [k for k, _ in jscales]

    qcfg = dict(mode="int8", scales=jscales, in_means=jmeans,
                bias_correct=True, per_channel_act=True)
    jq, _ = jax_build_model(cfg, quant=JQ.QuantCfg(**qcfg))
    (jdec, _), jseg = jax.jit(lambda v, a: jq.apply(v, a, train=False))(
        variables, jnp.asarray(x))
    jdec, jseg = np.asarray(jdec), np.asarray(jseg).transpose(0, 3, 1, 2)
    qm, _ = build_model(cfg, fuse_focus=True, quant=Q.QuantCfg(**qcfg))
    load_state_dict(qm, sd)
    with torch.no_grad():
        (dec, _), seg = qm.eval()(xt)
    dec, seg = dec.numpy(), seg.numpy()
    assert np.abs(dec - jdec).max() <= 0.02 * np.abs(jdec).max()
    assert np.abs(seg - jseg).max() <= 0.02 * np.abs(jseg).max()
    assert (seg.argmax(1) == jseg.argmax(1)).mean() >= 0.99
