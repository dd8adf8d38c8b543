"""Test-time augmentation and ensembles (``eval/tta.py``,
``eval/ensemble.py``) and the validator that runs them, JAX vs port, on
the CPU in f32.

tiny_psp2 on ``torch_detect_case``'s two members, at 64x64 and 64x96
(NCHW on the port, NHWC in JAX). ``scale_img`` (0.83 -> 53 px, 0.67 ->
42 px, padded to 64 with 0.447), ``descale_pred`` for every flip,
``forward_augment``, ``forward_augment_joint`` and ``ensemble_forward``
within 1e-4 (decodes with xywh divided by the image size, rtol and atol;
seg logits within 1e-4 of their largest magnitude); ``Validator(augment=
True)`` and a validation of a two-member ``EnsembleModel`` give JAX's
metrics within 1e-6 on two in-memory batches whose targets are the plain
model's own detections (conf 0.001, multi-label NMS: the JAX package's XLA
path against the port's plain K3).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_detect_case as D
from desenet_tpu.eval import ensemble as jax_ensemble
from desenet_tpu.eval import tta as jax_tta
from desenet_tpu.eval.validator import Validator as JaxValidator
from desenet_tpu_torch.eval import tta
from desenet_tpu_torch.eval.ensemble import EnsembleModel, ensemble_forward
from desenet_tpu_torch.eval.validator import Validator

BAR = dict(rtol=1e-4, atol=1e-4)


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    yield from D.one_thread()


@pytest.fixture(scope="module")
def members():
    """[(JAX model, variables, port model)] of the two members, full-
    resolution seg logits."""
    return [(*D.jax_variables(D.member_weights(k)), D.port_model(k))
            for k in (0, 1)]


def inputs(h: int, w: int, b: int = 2, seed: int = 0):
    x = np.random.default_rng(seed).uniform(0, 1, (b, h, w, 3)).astype(
        np.float32)
    return jnp.asarray(x), torch.from_numpy(x).permute(0, 3, 1, 2)


def nchw(a) -> np.ndarray:
    return np.asarray(a).transpose(0, 3, 1, 2)


def assert_dec_close(got, want, hw):
    """Decodes within the bar with xywh divided by the image size, as the
    label files hold them (a pixel-space decode carries the stride times
    the f32 noise of the logits)."""
    scale = np.asarray([hw[1], hw[0], hw[1], hw[0]], np.float32)
    got, want = np.array(got), np.array(want)
    got[..., :4] /= scale
    want[..., :4] /= scale
    np.testing.assert_allclose(got, want, **BAR)


def assert_seg_close(got, want):
    """Seg logits within 1e-4 of their largest magnitude: the tiny model's
    reach about 100, and the two forwards' f32 sums differ by about 2e-5
    of that."""
    want = nchw(want)
    assert np.abs(got - want).max() <= 1e-4 * np.abs(want).max()


@pytest.mark.parametrize("ratio", [0.83, 0.67, 1.0])
@pytest.mark.parametrize("hw", [(64, 64), (64, 96)])
def test_scale_img_matches_jax(ratio, hw):
    jx, px = inputs(*hw)
    got = tta.scale_img(px, ratio, 32)
    want = jax_tta.scale_img(jx, ratio, 32)
    np.testing.assert_allclose(got.numpy(), nchw(want), **BAR)
    assert got.shape[2] % 32 == 0 and got.shape[3] % 32 == 0
    if ratio != 1.0:
        # bf16: the pad value rounds the same in both (0.447265625)
        gb = tta.scale_img(px.to(torch.bfloat16), ratio, 32)
        wb = jax_tta.scale_img(jx.astype(jnp.bfloat16), ratio, 32)
        assert float(gb[0, 0, -1, -1]) == float(wb[0, -1, -1, 0]) == \
            0.447265625


@pytest.mark.parametrize("flip", ["", "lr", "ud"])
@pytest.mark.parametrize("scale", [1.0, 0.83])
def test_descale_pred_matches_jax(flip, scale):
    p = np.random.default_rng(1).uniform(0, 60, (2, 7, 8)).astype(np.float32)
    got = tta.descale_pred(torch.from_numpy(p), flip, scale, (64, 96))
    want = jax_tta.descale_pred(jnp.asarray(p), flip, scale, (64, 96))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **BAR)


@pytest.mark.parametrize("hw", [(64, 64), (64, 96)])
def test_forward_augment_joint_matches_jax(members, hw):
    jm, jv, pm = members[0]
    jx, px = inputs(*hw, seed=2)
    dec, seg = tta.forward_augment_joint(pm, px)
    jdec, jseg = jax.jit(
        lambda v, x: jax_tta.forward_augment_joint(jm, v, x))(jv, jx)
    assert_dec_close(dec.numpy(), jdec, hw)
    assert_seg_close(seg.numpy(), jseg)
    assert seg.dtype == torch.float32 and seg.shape[2:] == hw
    # forward_augment is the joint decode; the plain forward's output may
    # stand in for the identity variant
    np.testing.assert_array_equal(tta.forward_augment(pm, px).numpy(),
                                  dec.numpy())
    with torch.inference_mode():
        plain = pm(px)
    np.testing.assert_array_equal(
        tta.forward_augment(pm, px, plain=plain).numpy(), dec.numpy())


def test_forward_augment_on_the_eighth_resolution_head():
    """The detect program's model (1/8 seg logits): forward_augment runs,
    the seg average raises, as in JAX."""
    pm = D.port_model(0, seg_upsample=False)
    jm, jv = D.jax_variables(D.member_weights(0), seg_upsample=False)
    jx, px = inputs(64, 64, seed=3)
    got = tta.forward_augment(pm, px)
    want = jax.jit(lambda v, x: jax_tta.forward_augment(jm, v, x))(jv, jx)
    assert_dec_close(got.numpy(), want, (64, 64))
    assert got.shape[1] == 3 * 252
    with pytest.raises(ValueError, match="full-resolution"):
        tta.forward_augment_joint(pm, px)


def test_ensemble_forward_matches_jax(members):
    jx, px = inputs(64, 96, seed=4)
    dec, seg = ensemble_forward([m[2] for m in members], px)
    jdec, jseg = jax_ensemble.ensemble_forward(
        [(m[0], m[1], {}) for m in members], jx)
    assert_dec_close(dec.numpy(), jdec, (64, 96))
    assert_seg_close(seg.numpy(), jseg)
    assert dec.shape[1] == 2 * 3 * (8 * 12 + 4 * 6 + 2 * 3)
    ens = EnsembleModel([m[2] for m in members])
    assert ens.spec is members[0][2].spec and not ens.training
    # TTA composes with the ensemble: 64x96, 53x79 padded to 64x96, 42x64
    assert tta.forward_augment(ens, px).shape[1] == 2 * dec.shape[1] + 2 * 252


def batches(model, hw, n: int = 2, b: int = 3, m: int = 6):
    """``n`` in-memory batches of ``b`` noise images; the targets are up to
    ``m`` of ``model``'s own detections an image at conf 0.005, moved by up
    to 2 pixels, so the metrics count true positives."""
    from desenet_tpu_torch.ops import non_max_suppression

    rng = np.random.default_rng(5)
    h, w = hw
    out = []
    for _ in range(n):
        img = rng.integers(0, 256, (b, h, w, 3), dtype=np.uint8)
        with torch.inference_mode():
            (dec, _), _ = model(torch.from_numpy(img).permute(0, 3, 1, 2)
                                .float() / 255)
            nms = non_max_suppression(dec, 0.005, 0.45, max_det=m)
        xyxy = nms.boxes.numpy() + rng.uniform(-2, 2, (b, m, 4))
        xywhn = np.stack([(xyxy[..., 0] + xyxy[..., 2]) / 2 / w,
                          (xyxy[..., 1] + xyxy[..., 3]) / 2 / h,
                          (xyxy[..., 2] - xyxy[..., 0]) / w,
                          (xyxy[..., 3] - xyxy[..., 1]) / h], -1)
        tg = np.concatenate([nms.classes.numpy()[..., None].clip(0), xywhn],
                            -1).astype(np.float32)
        out.append({
            "image": img, "det_targets": tg, "det_mask": nms.valid.numpy(),
            "seg_labels": rng.integers(0, 2, (b, h, w), dtype=np.uint8),
            "shapes": [None] * b,
        })
    return out


def assert_metrics_equal(got, want, bar=1e-6):
    assert got["seen"] == want["seen"]
    assert set(got["per_class"]) == set(want["per_class"])
    for k in ("mp", "mr", "map50", "map", "miou", "pix_acc"):
        assert abs(got[k] - want[k]) <= bar, (k, got[k], want[k])


@pytest.mark.parametrize("what", ["augment", "ensemble", "ensemble+augment"])
def test_validator_matches_jax(members, what):
    data = batches(members[0][2], (64, 96))
    augment = "augment" in what
    n = 2 if "ensemble" in what else 1
    jmodel = (jax_ensemble.EnsembleModel([m[0] for m in members])
              if n == 2 else members[0][0])
    jvars = tuple(m[1] for m in members) if n == 2 else members[0][1]
    pmodel = (EnsembleModel([m[2] for m in members]) if n == 2
              else members[0][2])
    want = JaxValidator(jmodel, nc=3, se_nc=2, augment=augment).run(jvars,
                                                                     data)
    got = Validator(pmodel, nc=3, se_nc=2, augment=augment).run(data)
    assert_metrics_equal(got, want)
    assert got["seen"] == 6 and got["map50"] > 0 and got["miou"] > 0
