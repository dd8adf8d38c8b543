"""The port's serving export (``desenet_tpu_torch/tools/export_model.py``)
and its consumer (``tools/consume_exported_model.py``) against the live
program and the JAX package's export, on the CPU:

- one JAX checkpoint and one port checkpoint of the same tiny_psp2 weights
  (``torch_detect_case.write_checkpoints``); each package exports its own
  at 64 px in f32 (conf 0.02, so that the tiny net has detections);
- the port's artifact, run by the consumer in a fresh subprocess (torch
  and numpy only), equals the live program (``ServingProgram`` eagerly:
  ``non_max_suppression(backend="xla", pre_topk=1024)`` and the seg
  argmax): boxes within 1e-4, scores within 1e-5, classes, counts and the
  seg map equal; and the JAX artifact run by ``jax.export`` with the same
  counts, classes and seg map, its boxes within the served program's
  cross-framework bar (1e-3 px, ``test_torch_slice.py``: the two f32
  forwards differ by up to 7.5e-4 px on this image before any export);
- nothing on the exported path reaches the CUDA kernels' wrappers (K1, K2,
  K3 raise if called while exporting);
- the consumer imports only json, sys, numpy and torch (an ``ast`` check);
- ``non_max_suppression(backend="xla")`` against the JAX package's on
  seeded decodes: single-label, multi-label, agnostic, a class filter, a
  per-scale list.
"""

import ast
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax import export as jexport

from desenet_tpu.ops import non_max_suppression as jax_nms
from desenet_tpu_torch.ops import nms_fused, nms_pallas, seg_pallas
from desenet_tpu_torch.ops.nms import non_max_suppression
from desenet_tpu_torch.testing import synthetic_decode
from desenet_tpu_torch.tools import export_model
from torch_detect_case import one_thread, write_checkpoints

HERE = os.path.dirname(os.path.abspath(__file__))
REPO = os.path.dirname(HERE)
CONSUMER = os.path.join(REPO, "desenet_tpu_torch", "tools",
                        "consume_exported_model.py")
S = 64
CONF = "0.02"
_threads = pytest.fixture(scope="module", autouse=True)(one_thread)


def _raise(*a, **k):
    raise AssertionError("a CUDA kernel's wrapper on the exported path")


@pytest.fixture(scope="module")
def exported(tmp_path_factory):
    """(port checkpoint, port artifact, JAX artifact) of one member."""
    root = str(tmp_path_factory.mktemp("export"))
    jdir, pdir = write_checkpoints(root, 0)
    out = os.path.join(root, "model.pt2")
    mp = pytest.MonkeyPatch()
    for mod, name in ((nms_fused, "fused_select_nms"),
                      (nms_pallas, "greedy_nms_pallas"),
                      (seg_pallas, "upsample_argmax")):
        mp.setattr(mod, name, _raise)
    import desenet_tpu_torch.ops.nms as port_nms
    mp.setattr(port_nms, "fused_select_nms", _raise)
    mp.setattr(port_nms, "greedy_nms_pallas", _raise)
    try:
        export_model.main([pdir, out, "--img-size", str(S), "--fp32",
                           "--device", "cpu", "--conf-thres", CONF])
    finally:
        mp.undo()
    sys.path.insert(0, os.path.join(REPO, "tools"))
    try:
        import export_model as jax_export_model
    finally:
        sys.path.pop(0)
    jout = os.path.join(root, "model.stablehlo")
    jax_export_model.main([jdir, jout, "--batch", "1", "--img-size", str(S),
                           "--fp32", "--conf-thres", CONF])
    return pdir, out, jout, root


def _image(root):
    img = np.random.default_rng(3).integers(0, 255, (50, 70, 3), np.uint8)
    # a bright blob, so that the tiny net sees an object
    img[10:40, 20:50] = (220, 40, 40)
    path = os.path.join(root, "img.npy")
    np.save(path, img)
    return img, path


def _letterboxed(img):
    sys.path.insert(0, os.path.dirname(CONSUMER))
    try:
        import consume_exported_model as consumer
    finally:
        sys.path.pop(0)
    return consumer.letterbox_u8(img, S)[0][None]


def test_export_consumed_matches_live_and_jax(exported):
    pdir, out, jout, root = exported
    assert os.path.getsize(out) > 1000
    img, img_path = _image(root)
    npz = os.path.join(root, "outs.npz")
    # one intra-op thread, as this process: the same summation order
    env = dict(os.environ, PYTHONPATH="", OMP_NUM_THREADS="1")
    proc = subprocess.run(
        [sys.executable, CONSUMER, out, img_path, npz], capture_output=True,
        text=True, timeout=300, env=env, cwd=root)
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert "detections" in proc.stdout and "seg class histogram" in \
        proc.stdout
    got = dict(np.load(npz))
    assert got["seg"].shape == (1, S, S) and got["seg"].dtype == np.uint8
    assert int(got["num"][0]) > 0, proc.stdout

    batch = _letterboxed(img)
    prog, _ = export_model.load_program(pdir, torch.float32, "cpu",
                                        conf_thres=float(CONF))
    with torch.no_grad():
        live = [t.numpy() for t in prog(torch.from_numpy(batch))]
    exp = jexport.deserialize(open(jout, "rb").read())
    jax_out = [np.asarray(v) for v in exp.call(jnp.asarray(batch))]
    for name, want, box_tol in (("live", live, 1e-4),
                                ("JAX export", jax_out, 1e-3)):
        boxes, scores, classes, num, seg = want
        assert np.array_equal(got["num"], num), name
        n = int(num[0])
        np.testing.assert_allclose(got["boxes"][0, :n], boxes[0, :n],
                                   atol=box_tol, err_msg=name)
        np.testing.assert_allclose(got["scores"][0, :n], scores[0, :n],
                                   atol=1e-5, err_msg=name)
        assert np.array_equal(got["classes"][0, :n], classes[0, :n]), name
        assert np.array_equal(got["seg"], seg), name


def test_consumer_imports_only_torch_numpy_stdlib():
    tree = ast.parse(open(CONSUMER).read())
    mods = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            mods.update(a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module:
            mods.add(node.module.split(".")[0])
    assert mods == {"json", "sys", "numpy", "torch"}, mods


NMS_CASES = {
    "single": dict(multi_label=False),
    "multi": dict(multi_label=True, conf_thres=0.05),
    "agnostic": dict(agnostic=True),
    "classes": dict(classes=(0, 2)),
    "max_det": dict(max_det=5),
}


@pytest.mark.parametrize("case", list(NMS_CASES))
@pytest.mark.parametrize("per_scale", [False, True])
def test_nms_xla_backend_matches_jax(case, per_scale):
    rng = np.random.default_rng(len(case) + 10 * per_scale)
    dec = synthetic_decode(rng, 2, 600, 4, 0.05)
    kw = dict(dict(conf_thres=0.25, iou_thres=0.45, max_det=300,
                   pre_topk=256), **NMS_CASES[case])
    parts = np.split(dec, [400, 550], axis=1) if per_scale else [dec]
    arg = (lambda xs: list(xs)) if per_scale else (lambda xs: xs[0])
    got = non_max_suppression(arg([torch.from_numpy(p) for p in parts]),
                              backend="xla", **kw)
    want = jax_nms(arg([jnp.asarray(p) for p in parts]), backend="xla", **kw)
    assert np.array_equal(got.num.numpy(), np.asarray(want.num))
    assert int(got.num.sum()) > 0
    np.testing.assert_allclose(got.boxes.numpy(), np.asarray(want.boxes),
                               atol=1e-4)
    np.testing.assert_allclose(got.scores.numpy(), np.asarray(want.scores),
                               atol=1e-6)
    assert np.array_equal(got.classes.numpy(), np.asarray(want.classes))
    assert np.array_equal(got.valid.numpy(), np.asarray(want.valid))


def test_nms_xla_backend_exports_above_pre_topk():
    """Above ``pre_topk`` candidates the top-k set is a slice of the sorted
    row; the exported loop (``while_loop`` where torch has it) equals the
    eager one."""
    class Program(torch.nn.Module):
        def forward(self, d):
            out = non_max_suppression(d, backend="xla", pre_topk=1024,
                                      max_det=50)
            return out.boxes, out.num

    rng = np.random.default_rng(7)
    dec = torch.from_numpy(synthetic_decode(rng, 1, 3000, 4, 0.6))
    ep = torch.export.export(Program(), (dec,))
    got, want = ep.module()(dec), Program()(dec)
    assert int(want[1][0]) == 50
    assert all(torch.equal(g, w) for g, w in zip(got, want))


def test_nms_backend_refuses_unknown():
    with pytest.raises(ValueError, match="backend"):
        non_max_suppression(torch.zeros(1, 4, 7), backend="pallas")
