"""The JAX package's public box helpers in the port
(``desenet_tpu_torch/ops/boxes.py``: ``xyxy2xywh``, ``xywhn2xyxy``,
``xyxy2xywhn`` with and without clipping, ``xyn2xy``, ``clip_coords``,
``scale_coords`` with and without ``ratio_pad`` on boxes past the image
edge, ``wh_iou``, ``bbox_ioa``) against ``desenet_tpu/ops/boxes.py`` on the same seeded
numpy inputs, in f32 on the CPU: within 1e-6 relative (the same
arithmetic in the same order), exported from ``ops`` as the JAX package
exports them."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import desenet_tpu.ops as jops
import desenet_tpu_torch.ops as tops

RNG = np.random.default_rng(0)
XYWHN = RNG.uniform(0.05, 0.95, (3, 7, 4)).astype(np.float32)
CORNERS = RNG.uniform(-40, 700, (3, 7, 2, 2)).astype(np.float32)
XYXY = np.concatenate([CORNERS.min(2), CORNERS.max(2)], -1)  # some outside
POINTS = RNG.uniform(0, 1, (5, 2)).astype(np.float32)
WH1 = RNG.uniform(1, 100, (6, 2)).astype(np.float32)
WH2 = RNG.uniform(1, 100, (4, 2)).astype(np.float32)

CASES = {
    "xyxy2xywh": ((XYXY,), {}),
    "xywhn2xyxy": ((XYWHN,), dict(w=608, h=416, padw=3, padh=5)),
    "xyxy2xywhn": ((XYXY,), dict(w=640, h=480)),
    "xyxy2xywhn_clip": ((XYXY,), dict(w=640, h=480, clip=True, eps=1e-3)),
    "xyn2xy": ((POINTS,), dict(w=320, h=256, padw=2, padh=7)),
    "clip_coords": ((XYXY, (300, 500)), {}),
    "wh_iou": ((WH1, WH2), {}),
    "bbox_ioa": ((XYXY[0, 0], XYXY[1]), {}),
    # letterboxed 640x640 back to 480x600 and a batch to 1080x1920; the
    # corners reach past both images, so the clip is exercised
    "scale_coords": (((640, 640), XYXY[0], (480, 600)), {}),
    "scale_coords_batch": (((384, 640), XYXY, (1080, 1920)), {}),
    "scale_coords_ratio_pad": (((640, 640), XYXY[1], (480, 600)),
                               dict(ratio_pad=((0.9, 0.9), (12.5, 7.0)))),
}
SUFFIXES = ("_clip", "_batch", "_ratio_pad")


@pytest.mark.parametrize("name", sorted(CASES))
def test_box_helper_matches_jax(name):
    args, kw = CASES[name]
    fn = name
    for suffix in SUFFIXES:
        fn = fn.removesuffix(suffix)
    assert fn in tops.__all__ and fn in jops.__all__
    want = np.asarray(getattr(jops, fn)(
        *[jnp.asarray(a) if isinstance(a, np.ndarray) else a for a in args],
        **kw))
    got = getattr(tops, fn)(
        *[torch.from_numpy(a) if isinstance(a, np.ndarray) else a
          for a in args], **kw).numpy()
    assert got.shape == want.shape and got.dtype == np.float32
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)
