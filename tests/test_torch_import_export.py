"""The port's checkpoint import and export
(``desenet_tpu_torch/tools/import_torch_ckpt.py``, ``export_torch_sd.py``)
on the CPU:

- the tiny_psp2 golden's ``sd__`` weights in a reference-style checkpoint
  (a pickled port module, f32) are imported and served by
  ``api.load_predictor``, matching the golden's decode, features and seg
  logits at the golden test's 2e-5 (``test_torch_model_parity.py``);
- the same weights in half match the JAX package's model on
  ``convert_state_dict`` of the same half weights at the cross-framework
  bar of ``test_torch_model_parity.py`` (1e-4);
- the export of a port checkpoint equals, key for key and bit for bit,
  what ``tools/export_torch_sd.export_state_dict`` writes for the same
  weights saved as a JAX checkpoint, on tiny_psp2 (Focus- and fused-stem
  port checkpoints) and on full-width yolov5s_seg (no forward);
- an export imported again gives back the same checkpoint, bit for bit;
- the checkpoint's Detect anchors, where they differ from the config's,
  are reported in one line and change nothing;
- a directory with no port checkpoint raises an error that names the
  tools of each direction.
"""

import json
import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import orbax.checkpoint as ocp
import pytest
import torch
from flax import traverse_util
from test_torch_checkpoint_migrate import jax_variables

from desenet_tpu.models import build_model as jax_build_model
from desenet_tpu.models import config_path as jax_config_path
from desenet_tpu.utils.torch_convert import convert_state_dict
from desenet_tpu_torch.api import load_predictor
from desenet_tpu_torch.models import build_model, config_path, init_weights
from desenet_tpu_torch.models.heads import _out
from desenet_tpu_torch.tools import export_torch_sd, import_torch_ckpt
from desenet_tpu_torch.utils import checkpoint as tckpt
from desenet_tpu_torch.utils.convert import load_state_dict, state_dict_from_jax

HERE = os.path.dirname(os.path.abspath(__file__))
TINY = os.path.join(HERE, "configs", "tiny_psp2.yaml")
GOLDEN_BAR = 2e-5
JAX_BAR = 1e-4


def golden():
    with np.load(os.path.join(HERE, "goldens", "tiny_psp2.npz")) as z:
        sd = {k[4:]: torch.from_numpy(z[k]) for k in z.files
              if k.startswith("sd__")}
        ref = {k: z[k] for k in z.files if not k.startswith("sd__")}
    return sd, ref


def save_reference(path, obj) -> None:
    """``obj`` (a module or a mapping of tensors) as the reference's
    train.py saves a checkpoint."""
    torch.save({"epoch": -1, "best_fitness": None, "training_results": None,
                "model": obj, "ema": obj, "updates": 0, "optimizer": None,
                "wandb_id": None}, path)


def import_golden(tmp_path, half: bool):
    sd, ref = golden()
    model, _ = build_model(TINY)
    load_state_dict(model, sd)
    if half:
        model.half()
    pt = str(tmp_path / "best.pt")
    save_reference(pt, model.eval())
    out = str(tmp_path / "imported")
    meta = import_torch_ckpt.main([pt, out, "--cfg", TINY, "--de-names", "a",
                                   "b", "c"])
    pred = load_predictor(out, imgsz=64, conf_thres=1e-3, half=False,
                          device="cpu")
    with torch.no_grad():
        (dec, feats), seg = pred.model(torch.from_numpy(ref["x"]))
    return pred, meta, out, (dec, feats, _out(seg, 8)), ref


def test_imported_golden_serves(tmp_path):
    pred, meta, out, (dec, feats, seg), ref = import_golden(tmp_path, False)
    np.testing.assert_allclose(dec.numpy(), ref["dec"], atol=GOLDEN_BAR)
    for i in range(3):
        np.testing.assert_allclose(feats[i].numpy(), ref[f"feat{i}"],
                                   atol=GOLDEN_BAR)
    np.testing.assert_allclose(seg.numpy(), ref["seg"], atol=GOLDEN_BAR)
    with open(os.path.join(out, "meta.json")) as fh:
        written = json.load(fh)
    assert written == {**meta, "schema_version": 3, "format": "torch",
                       "layout": {"focus": "focus", "c3": "unfused"}}
    assert meta["imgsz"] == 640 and meta["se_names"] == ["0", "1"]
    assert meta["source"] == str(tmp_path / "best.pt")
    res = pred(np.random.default_rng(0).integers(0, 256, (64, 64, 3),
                                                 dtype=np.uint8))
    assert res.masks[0].shape == (64, 64) and pred.names == ["a", "b", "c"]


def test_imported_half_weights_match_jax(tmp_path):
    _, _, _, (dec, feats, seg), ref = import_golden(tmp_path, True)
    sd, _ = golden()
    half = {k: v.half().float().numpy() for k, v in sd.items()}
    jmodel, jspec = jax_build_model(TINY)
    variables, report = convert_state_dict(
        half, jax_variables(TINY, 0), jspec)
    assert not report["missing"]
    x = np.transpose(ref["x"], (0, 2, 3, 1))
    (jdec, jfeats), jseg = jax.jit(jmodel.apply, static_argnames="train")(
        variables, jnp.asarray(x), train=False)
    np.testing.assert_allclose(dec.numpy(), np.asarray(jdec), atol=JAX_BAR)
    for f, jf in zip(feats, jfeats):
        np.testing.assert_allclose(f.numpy(), np.asarray(jf), atol=JAX_BAR)
    np.testing.assert_allclose(seg.permute(0, 2, 3, 1).numpy(),
                               np.asarray(jseg), atol=JAX_BAR)
    # the half weights differ from the f32 golden's, so the outputs do
    assert np.abs(dec.numpy() - ref["dec"]).max() > GOLDEN_BAR


def jax_tool_export(tmp_path, cfg, variables):
    """``tools/export_torch_sd.export_state_dict`` of ``variables`` saved
    as a JAX checkpoint of ``cfg`` (a bundled name or a path)."""
    sys.path.insert(0, os.path.join(HERE, "..", "tools"))
    try:
        from export_torch_sd import export_state_dict
    finally:
        sys.path.pop(0)
    jdir = str(tmp_path / "jax_ckpt")
    ocp.PyTreeCheckpointer().save(jdir, variables, force=True)
    _, spec = jax_build_model(jax_config_path(cfg))
    with open(os.path.join(jdir, "meta.json"), "w") as fh:
        json.dump({"cfg": cfg, "de_nc": spec.de_nc, "se_nc": spec.se_nc,
                   "schema_version": 3,
                   "layout": {"focus": "fused", "c3": "fused"}}, fh)
    return export_state_dict(jdir)[0]


def write_port_checkpoint(path, cfg, sd, fuse_focus=False):
    """``sd`` loaded into the port model of ``cfg`` and written as a
    stripped checkpoint directory; returns its meta."""
    model, spec = build_model(config_path(cfg), fuse_focus=fuse_focus)
    load_state_dict(model, sd)
    params, stats = tckpt.split_stats(
        {k: v for k, v in model.state_dict().items()
         if k not in model.quirk_bn_keys()
         and not k.endswith("num_batches_tracked")})
    meta = {"cfg": cfg, "de_nc": spec.de_nc, "se_nc": spec.se_nc}
    tckpt._write(path, {"params": params, "batch_stats": stats}, meta)
    return meta


@pytest.mark.parametrize("cfg,fuse_focus", [(TINY, False), (TINY, True),
                                            ("yolov5s_seg", False)],
                         ids=["tiny_psp2", "tiny_psp2_fused_stem",
                              "yolov5s_seg"])
def test_export_matches_jax_tool(tmp_path, cfg, fuse_focus):
    variables = jax_variables(jax_config_path(cfg), 16, fused_csp=True)
    want = jax_tool_export(tmp_path, cfg, variables)
    spec = build_model(config_path(cfg))[1]
    sd, _ = state_dict_from_jax(traverse_util.flatten_dict(variables,
                                                           sep="/"), spec)
    pdir = str(tmp_path / "port_ckpt")
    write_port_checkpoint(pdir, cfg, sd, fuse_focus)
    npz = str(tmp_path / "sd.npz")
    assert export_torch_sd.main([pdir, npz])["tensors"] == len(want)
    with np.load(npz) as z:
        got = {k: z[k] for k in z.files}
    assert sorted(got) == sorted(want)
    for k, v in want.items():
        assert got[k].dtype == v.dtype == np.float32, k
        assert got[k].shape == v.shape and np.array_equal(got[k], v), k


def test_export_then_import_gives_the_checkpoint_back(tmp_path):
    model, _ = build_model(TINY)
    sd = init_weights(model, torch.Generator().manual_seed(16)).state_dict()
    src = str(tmp_path / "src")
    write_port_checkpoint(src, TINY, sd)
    npz = str(tmp_path / "sd.npz")
    export_torch_sd.main([src, npz])
    pt = str(tmp_path / "back.pt")
    with np.load(npz) as z:  # a mapping of tensors in the checkpoint
        save_reference(pt, {k: torch.from_numpy(z[k]) for k in z.files})
    back = str(tmp_path / "back")
    import_torch_ckpt.main([pt, back, "--cfg", TINY])
    a, b = tckpt.load_checkpoint(src), tckpt.load_checkpoint(back)
    for col in ("params", "batch_stats"):
        assert sorted(a[col]) == sorted(b[col])
        for k, v in a[col].items():
            assert torch.equal(b[col][k], v), k


def test_anchors_that_differ_are_reported(tmp_path, capsys):
    sd, _ = golden()
    model, spec = build_model(TINY)
    strides = torch.tensor(spec.det_strides, dtype=torch.float32)
    grid = torch.tensor(spec.anchors).view(3, -1, 2) / strides.view(-1, 1, 1)
    key = f"model.{spec.det_layer}.anchors"
    outs = {}
    for name, anchors in (("same", grid), ("other", grid * 1.25)):
        pt = str(tmp_path / f"{name}.pt")
        save_reference(pt, {**sd, key: anchors.half()})
        outs[name] = str(tmp_path / name)
        import_torch_ckpt.main([pt, outs[name], "--cfg", TINY])
        lines = [ln for ln in capsys.readouterr().out.splitlines()
                 if ln.startswith("anchors:")]
        assert len(lines) == (name == "other"), lines
    a = tckpt.load_checkpoint(outs["same"])
    b = tckpt.load_checkpoint(outs["other"])
    assert a["meta"] == {**b["meta"], "source": a["meta"]["source"]}
    assert "anchors" not in a["meta"]
    assert all(torch.equal(a["params"][k], v) for k, v in b["params"].items())


def test_a_directory_without_weights_names_the_tools(tmp_path):
    """``utils/checkpoint.load_checkpoint``'s error names the port's import
    for a reference .pt, the JAX tool for a JAX checkpoint, and the port's
    export for the way back."""
    with pytest.raises(FileNotFoundError) as err:
        tckpt.load_checkpoint(str(tmp_path))
    for name in ("desenet_tpu_torch.tools.import_torch_ckpt",
                 "tools/export_torch_sd.py", "train_state_from_jax",
                 "desenet_tpu_torch.tools.export_torch_sd"):
        assert name in str(err.value), name
