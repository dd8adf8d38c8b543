"""The phase-layout (space-to-depth-4) stem of the port
(``desenet_tpu_torch/ops/s2d.py``, ``models/layers.py``
``PhaseStemA``/``PhaseStemB``, ``build_model(stem_s2d=True)``,
``native.assemble_batch_s2d4``, ``Predictor(stem_s2d=...)``) against the
JAX package's (``tests/test_stem_s2d.py``'s cases) on the CPU, on the same
numpy-seeded inputs and crossed weights:

- the s2d copies equal JAX's (torch and numpy, the native batch assembler
  and its opted-out path); H or W not divisible by 4 raises;
- the phase kernels equal ``phase_stem_kernel_a/b`` (OIHW here, HWIO
  there);
- tiny_psp2 in f32 on ``torch_detect_case``'s served weights: the
  stem's output against the standard stem's and JAX's ``stem_s2d`` one at
  JAX's own bar (rtol 2e-4, atol 2e-5); the model's eval outputs against
  JAX's ``stem_s2d`` forward and against the standard stem's at rtol 2e-4
  and an atol of 5e-5 of the largest magnitude (the served weights carry
  outputs to 74, where f32 sums taken in another order through 24 layers
  differ by up to 9e-4, 1.2e-5 of it); the
  training forward and the BN running statistics against JAX's and the
  standard stem's at JAX's bars (outputs rtol 5e-3, statistics rtol and
  atol 2e-3), the outputs' atol 1e-4 taken of the largest magnitude;
- the stem alone in training: gradients of W6, W1 and the BN parameters
  against JAX's ``PhaseStemA/B`` at JAX's rtol 1e-4, the atol 1e-4 taken
  of the largest gradient (sums over 2 x 16 x 16 pixels in another order);
- the same state-dict keys and shapes as the standard stem (yolov5s_seg);
- the configs ``_check_stem_s2d`` rejects, the spatial scope's refusal,
  and ``Predictor`` building the standard stem where it cannot rewrite it
  or serves int8;
- ``Predictor(stem_s2d=True, device="cpu")`` against the standard stem at
  JAX's geometry bars (``tests/test_engine.py``'s
  ``test_predictor_stem_s2d_geometry_parity``) and against the JAX
  package's ``Predictor(stem_s2d=True)`` on the same checkpoint at
  ``test_torch_detect``'s bars.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import linen as fnn

import desenet_tpu.models.layers as JL
import torch_detect_case as D
from desenet_tpu.api import Predictor as JaxPredictor
from desenet_tpu.ops.s2d import space_to_depth4 as jax_s2d
from desenet_tpu.ops.s2d import space_to_depth4_np as jax_s2d_np
from desenet_tpu_torch import native
from desenet_tpu_torch import quant as Q
from desenet_tpu_torch.api import Predictor, load_predictor
from desenet_tpu_torch.models import build_model, config_path
from desenet_tpu_torch.models import layers as L
from desenet_tpu_torch.ops.s2d import space_to_depth4, space_to_depth4_np
from desenet_tpu_torch.parallel import spatial
from desenet_tpu_torch.utils.convert import load_state_dict
from test_torch_api_multidevice import assert_like_jax
from test_torch_slice import tiny_cfg

KW = dict(imgsz=64, half=False, conf_thres=1e-6, max_det=20)


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    yield from D.one_thread()


def nchw(x: np.ndarray) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(x.transpose(0, 3, 1, 2)))


def s2d_nchw(x: np.ndarray) -> torch.Tensor:
    return space_to_depth4(torch.from_numpy(x)).permute(0, 3, 1, 2)


@pytest.fixture(scope="module")
def case():
    """Served weights (torch-named numpy), JAX's standard and s2d models on
    them, an input, and the port's two models."""
    sd = D.member_weights(0)
    jbase, variables = D.jax_variables(sd)
    from desenet_tpu.models import build_model as jax_build_model

    jphase, _ = jax_build_model(tiny_cfg(), stem_s2d=True)
    x = np.random.default_rng(2).uniform(0, 1, (2, 64, 64, 3)).astype(
        np.float32)
    ports = []
    for s2d in (False, True):
        m, _ = build_model(tiny_cfg(), fuse_focus=True, stem_s2d=s2d)
        load_state_dict(m, {k: torch.from_numpy(v) for k, v in sd.items()})
        ports.append(m.eval())
    return sd, jphase, variables, x, ports


def test_s2d_copies_match_jax(monkeypatch):
    x = np.random.default_rng(0).integers(0, 256, (3, 8, 12, 3), np.uint8)
    want = jax_s2d_np(x)
    np.testing.assert_array_equal(space_to_depth4_np(x), want)
    np.testing.assert_array_equal(space_to_depth4_np(x[0]), want[0])
    np.testing.assert_array_equal(
        space_to_depth4(torch.from_numpy(x)).numpy(),
        np.asarray(jax_s2d(jnp.asarray(x))))
    np.testing.assert_array_equal(native.assemble_batch_s2d4(list(x)), want)
    # a strided sample is read as its values
    np.testing.assert_array_equal(
        native.assemble_batch_s2d4([x[0][:, ::-1], x[1]]),
        jax_s2d_np(np.stack([x[0][:, ::-1], x[1]])))
    monkeypatch.setenv("DESENET_NATIVE", "0")
    assert not native.available()
    np.testing.assert_array_equal(native.assemble_batch_s2d4(list(x)), want)
    for bad in (lambda: space_to_depth4_np(x[:, :6]),
                lambda: space_to_depth4(torch.from_numpy(x[:, :, :10])),
                lambda: native.assemble_batch_s2d4([x[0, :6]])):
        with pytest.raises(ValueError, match="divisible by 4"):
            bad()


def test_phase_kernels_match_jax():
    rng = np.random.default_rng(1)
    w6 = rng.normal(0, 1, (6, 6, 3, 8)).astype(np.float32)  # HWIO
    w1 = rng.normal(0, 1, (3, 3, 8, 16)).astype(np.float32)
    got_a = L.phase_stem_kernel_a(torch.from_numpy(w6.transpose(3, 2, 0, 1)))
    got_b = L.phase_stem_kernel_b(torch.from_numpy(w1.transpose(3, 2, 0, 1)))
    assert got_a.shape == (32, 48, 3, 3) and got_b.shape == (16, 32, 2, 2)
    np.testing.assert_array_equal(
        got_a.numpy(), np.asarray(JL.phase_stem_kernel_a(jnp.asarray(w6)))
        .transpose(3, 2, 0, 1))
    np.testing.assert_array_equal(
        got_b.numpy(), np.asarray(JL.phase_stem_kernel_b(jnp.asarray(w1)))
        .transpose(3, 2, 0, 1))


def _stem_out(model, x):
    with torch.no_grad():
        return model.model[1](model.model[0](x))


def test_eval_forward_matches_jax_and_standard_stem(case):
    sd, jphase, variables, x, (base, phase) = case
    (jdec, _), jseg = jax.jit(lambda v, a: jphase.apply(v, a, train=False))(
        variables, jax_s2d(jnp.asarray(x)))
    jstem = jphase.apply(variables, jax_s2d(jnp.asarray(x)), train=False,
                         up_to=1)
    with torch.no_grad():
        (dec_b, _), seg_b = base(nchw(x))
        (dec_p, _), seg_p = phase(s2d_nchw(x))
    stem_b, stem_p = _stem_out(base, nchw(x)), _stem_out(phase, s2d_nchw(x))
    assert float(stem_p.abs().max()) > 0.5  # a stem with signal
    jstem = np.asarray(jstem).transpose(0, 3, 1, 2)
    for want in (stem_b.numpy(), jstem):
        np.testing.assert_allclose(stem_p.numpy(), want, rtol=2e-4,
                                   atol=2e-5)
    for got, want in ((dec_p, np.asarray(jdec)),
                      (seg_p, np.asarray(jseg).transpose(0, 3, 1, 2)),
                      (dec_p, dec_b.numpy()), (seg_p, seg_b.numpy())):
        np.testing.assert_allclose(got.numpy(), want, rtol=2e-4,
                                   atol=5e-5 * np.abs(want).max())


def test_train_forward_and_bn_stats_match(case):
    sd, jphase, variables, x, _ = case
    (jdet, jseg), mut = jax.jit(lambda v, a: jphase.apply(
        v, a, train=True, mutable=["batch_stats"]))(
            variables, jax_s2d(jnp.asarray(x)))
    outs = {}
    for s2d in (False, True):
        m, _ = build_model(tiny_cfg(), fuse_focus=True, stem_s2d=s2d,
                           train=True)
        load_state_dict(m, {k: torch.from_numpy(v) for k, v in sd.items()})
        with torch.no_grad():
            det, seg = m(s2d_nchw(x) if s2d else nchw(x))
        outs[s2d] = (det, seg, m.state_dict())
    det, seg, st = outs[True]
    for got, want in zip(list(det) + [seg], list(jdet) + [jseg]):
        want = np.asarray(want)
        want = want.transpose(0, 3, 1, 2) if want.ndim == 4 else want
        np.testing.assert_allclose(got.numpy(), want, rtol=5e-3,
                                   atol=1e-4 * np.abs(want).max())
    for got, want in zip(list(det) + [seg],
                         list(outs[False][0]) + [outs[False][1]]):
        np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=5e-3,
                                   atol=1e-4)
    jstats = mut["batch_stats"]
    for i in (0, 1):
        for leaf, key in (("mean", "running_mean"), ("var", "running_var")):
            want = np.asarray(jstats[f"l{i}"]["bn"]["bn"][leaf])
            got = st[f"model.{i}.bn.{key}"].numpy()
            np.testing.assert_allclose(got, want, rtol=2e-3, atol=2e-3)
            np.testing.assert_allclose(
                got, outs[False][2][f"model.{i}.bn.{key}"].numpy(),
                rtol=2e-3, atol=2e-3)
    assert not np.allclose(st["model.0.bn.running_var"].numpy(), 1.0)


class _JaxPhaseStem(fnn.Module):
    @fnn.compact
    def __call__(self, x, train=True):
        x = JL.PhaseStemA(c2=32, ci=3, name="l0")(x, train)
        return JL.PhaseStemB(c2=64, ci=32, name="l1")(x, train)


def test_stem_grads_match_jax():
    """The stem alone in training (tests/test_stem_s2d.py's stem-local
    case): the gradients of sum(sin(y)) with respect to W6, W1 and the BN
    parameters."""
    rng = np.random.default_rng(3)
    x = rng.uniform(0, 1, (2, 64, 64, 3)).astype(np.float32)
    w6 = rng.normal(0, 0.1, (32, 3, 6, 6)).astype(np.float32)
    w1 = rng.normal(0, 0.06, (64, 32, 3, 3)).astype(np.float32)
    ga = [rng.uniform(0.5, 1.5, 32).astype(np.float32),
          rng.normal(0, 0.1, 32).astype(np.float32)]
    gb = [rng.uniform(0.5, 1.5, 64).astype(np.float32),
          rng.normal(0, 0.1, 64).astype(np.float32)]
    a, b = L.PhaseStemA(3, 32), L.PhaseStemB(32, 64)
    with torch.no_grad():
        for mod, w, (s, t) in ((a, w6, ga), (b, w1, gb)):
            mod.conv.weight.copy_(torch.from_numpy(w))
            mod.bn.weight.copy_(torch.from_numpy(s))
            mod.bn.bias.copy_(torch.from_numpy(t))
    torch.sin(b(a(s2d_nchw(x)))).sum().backward()
    jm = _JaxPhaseStem()
    xs = jax_s2d(jnp.asarray(x))
    v = jax.device_get(jm.init(jax.random.PRNGKey(0), xs))

    def bn(s, t):
        return {"bn": {"scale": jnp.asarray(s), "bias": jnp.asarray(t)}}

    params = {
        "l0": {"conv": {"conv2d": {"kernel": jnp.asarray(
            w6.transpose(2, 3, 1, 0))}}, "bn": bn(*ga)},
        "l1": {"conv": {"conv2d": {"kernel": jnp.asarray(
            w1.transpose(2, 3, 1, 0))}}, "bn": bn(*gb)}}

    def loss(p):
        y, _ = jm.apply({"params": p, "batch_stats": v["batch_stats"]}, xs,
                        train=True, mutable=["batch_stats"])
        return jnp.sum(jnp.sin(y))

    g = jax.grad(loss)(params)
    for i, mod in ((0, a), (1, b)):
        gi = g[f"l{i}"]
        for got, want in (
                (mod.conv.weight.grad.numpy(), np.asarray(
                    gi["conv"]["conv2d"]["kernel"]).transpose(3, 2, 0, 1)),
                (mod.bn.weight.grad.numpy(), gi["bn"]["bn"]["scale"]),
                (mod.bn.bias.grad.numpy(), gi["bn"]["bn"]["bias"])):
            want = np.asarray(want)
            assert np.abs(want).max() > 0
            np.testing.assert_allclose(got, want, rtol=1e-4,
                                       atol=1e-4 * np.abs(want).max())


def test_state_dict_keys_and_shapes_identical():
    shapes = []
    for s2d in (False, True):
        m, _ = build_model(config_path("yolov5s_seg"), fuse_focus=True,
                           stem_s2d=s2d)
        shapes.append({k: tuple(v.shape) for k, v in m.state_dict().items()})
    assert shapes[0] == shapes[1]
    assert shapes[1]["model.0.conv.weight"] == (32, 3, 6, 6)
    assert shapes[1]["model.1.conv.weight"] == (64, 32, 3, 3)


CONV_FIRST = {
    "de_nc": 2, "depth_multiple": 1.0, "width_multiple": 1.0,
    "anchors": [[10, 13, 16, 30, 33, 23]],
    "backbone": [[-1, 1, "Conv", [16, 3, 2]]],
    "head": [[[-1], 1, "Detect", [2, "anchors"]]],
}


@pytest.mark.parametrize("what", ["conv_first", "focus_unfused", "int8",
                                  "l1_stride_1"])
def test_rejected_configs(what):
    cfg, kw = tiny_cfg(), dict(fuse_focus=True)
    if what == "conv_first":
        cfg = CONV_FIRST
    elif what == "focus_unfused":
        kw["fuse_focus"] = False
    elif what == "int8":
        kw["quant"] = Q.QuantCfg(mode="calib")
    else:
        cfg["backbone"][1] = [-1, 1, "Conv", [128, 3, 1]]
    with pytest.raises(ValueError, match="stem_s2d"):
        build_model(cfg, stem_s2d=True, **kw)


def test_spatial_scope_refused(case, monkeypatch):
    monkeypatch.setattr(spatial, "active", lambda: True)  # as in a scope
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        case[4][1](s2d_nchw(case[3]))


def test_predictor_builds_the_standard_stem_where_it_must(case):
    sd = {k: torch.from_numpy(v) for k, v in case[0].items()}
    img = np.random.default_rng(4).integers(0, 256, (64, 64, 3), np.uint8)
    unfused = Predictor(tiny_cfg(), sd, device="cpu", half=False,
                        fuse_focus=False, stem_s2d=True, imgsz=64)
    assert unfused.stem_s2d is False
    q = Predictor(tiny_cfg(), sd, device="cpu", int8=True, calib=[img],
                  stem_s2d=True, imgsz=64)
    assert q.stem_s2d is False
    assert Predictor(tiny_cfg(), sd, device="cpu", half=False,
                     imgsz=64).stem_s2d is False


@pytest.fixture(scope="module")
def ckpts(tmp_path_factory):
    return D.write_checkpoints(str(tmp_path_factory.mktemp("s2d")), 0)


def test_predictor_stem_s2d_geometry_parity(ckpts):
    rng = np.random.default_rng(5)
    imgs = [rng.integers(0, 255, (70, 90, 3), np.uint8),
            rng.integers(0, 255, (90, 52, 3), np.uint8)]
    plain = load_predictor(ckpts[1], stem_s2d=False, device="cpu", **KW)
    s2d = load_predictor(ckpts[1], stem_s2d=True, device="cpu", **KW)
    assert s2d.stem_s2d is True and plain.stem_s2d is False
    r0, r1 = plain(imgs), s2d(imgs)
    for a, b, im in zip(r0.xyxy, r1.xyxy, imgs):
        assert len(a) > 0 and a.shape == b.shape
        np.testing.assert_allclose(b, a, atol=0.5)
    for a, b, im in zip(r0.masks, r1.masks, imgs):
        assert a.shape == b.shape == im.shape[:2]
        assert (a != b).mean() < 0.02
    assert_like_jax(r1, JaxPredictor(ckpts[0], stem_s2d=True, **KW)(imgs))
