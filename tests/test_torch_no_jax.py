"""desenet_tpu_torch imports (every module), serves (a PSP2 and a BiSe
tiny model, and yolov5m_seg at full width; the tiny model also as the
int8 program, calibrated on one image, and built with fp8 activation
storage), validates (on an in-memory
loader), takes two training steps, runs the training engine's
epoch loop (``train.engine.fit``: one epoch on in-memory batches, the EMA
validated, checkpoints written, reloaded and stripped), serves a checkpoint
through ``load_predictor``, runs the detect program plain, with TTA and on
an ensemble, validates an ensemble with TTA, scores by the COCO protocol,
runs its kernel probes (K5, K6), builds and loads its native host library
(``native.py``: the assembler, the rasterizer, the scaled JPEG decode),
takes a data-parallel step in two gloo processes
(``tools/dryrun_multichip.run``), logs a dataset through ``cli.log_dataset``
(the offline W&B backend), exports a checkpoint's serving program and runs
it through the consumer, runs ``utils/profiling.model_info`` and a
block the DSL cannot name, exports a checkpoint as the reference's state
dict, imports that back and serves it, and fuzzes the DSL compiler, with
the JAX package
``desenet_tpu``, JAX, flax, optax, orbax, cv2, PyYAML, matplotlib and
pandas blocked: the port never needs JAX or the JAX package, and the
card's machine may lack the other four. A second test reads the port's sources and ``chip_smoke.py`` with
``ast`` and fails on any import of those, at module level or inside a
function."""

import ast
import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

SCRIPT = r"""
import sys
BLOCKED = ("jax", "jaxlib", "flax", "optax", "orbax", "orbax.checkpoint",
           "cv2", "yaml", "matplotlib", "pandas")
for m in BLOCKED:
    sys.modules[m] = None  # any import of these raises ImportError


class BlockJaxPackage:
    # a meta-path finder that refuses the JAX package and its submodules

    def find_spec(self, name, path=None, target=None):
        if name == "desenet_tpu" or name.startswith("desenet_tpu."):
            raise ImportError(f"{name} is blocked: the port must not import "
                              "the JAX package")
        return None


sys.meta_path.insert(0, BlockJaxPackage())

import importlib
import json
import pkgutil
import numpy as np
import torch

# one intra-op thread: the test workers run beside it, and torch's spinning
# pool slows tenfold when the cores are oversubscribed
torch.set_num_threads(1)

import desenet_tpu_torch
from desenet_tpu_torch.api import Predictor
from desenet_tpu_torch.cli import serve as cli_serve  # noqa: F401
from desenet_tpu_torch.cli import show_seg_miou, val as cli_val  # noqa: F401
from desenet_tpu_torch.cli import train as cli_train  # noqa: F401
from desenet_tpu_torch.train import engine
from desenet_tpu_torch.utils import autoanchor, callbacks  # noqa: F401
from desenet_tpu_torch.utils import checkpoint, loggers  # noqa: F401
from desenet_tpu_torch.eval import Validator
from desenet_tpu_torch.models import build_model, config_path, init_weights
from desenet_tpu_torch.ops import c3_fused, stem_pallas  # noqa: F401
from desenet_tpu_torch.serve import BatchRunner, InferenceServer  # noqa: F401
from desenet_tpu_torch.tools import probe_stem_pallas, proto_c3_kernel
from desenet_tpu_torch.tools import profile_served  # noqa: F401
from desenet_tpu_torch.utils import fold  # noqa: F401

# every module of the port imports with all of that blocked
names = sorted(m.name for m in pkgutil.walk_packages(
    desenet_tpu_torch.__path__, "desenet_tpu_torch."))
assert len(names) > 30, names
for name in names:
    importlib.import_module(name)
try:
    import desenet_tpu.serve  # noqa: F401
except ImportError:
    pass
else:
    raise AssertionError("the JAX package was not blocked")

model, spec = build_model(config_path("yolov5s_seg"))
assert sum(p.numel() for p in model.parameters()) == 7594268

with open(config_path("yolov5s_seg")) as fh:
    cfg = json.load(fh)
cfg.update(width_multiple=0.125, de_nc=3, se_nc=2)
tiny, _ = build_model(cfg)
sd = init_weights(tiny, torch.Generator().manual_seed(0)).state_dict()
pred = Predictor(cfg, sd, imgsz=64, conf_thres=1e-3, half=False,
                 device="cpu")
img = np.random.default_rng(0).integers(0, 256, (64, 64, 3), dtype=np.uint8)
res = pred(img)
assert len(res) == 1 and res.masks[0].shape == (64, 64)
assert res.xyxy[0].shape[1] == 6

# the int8 program (quant.py, ops/int8_conv.py's plain version on the CPU)
# and the fp8-storage model
from desenet_tpu_torch import quant
from desenet_tpu_torch.ops import int8_conv
q8 = Predictor(cfg, sd, imgsz=64, conf_thres=1e-3, half=False, device="cpu",
               int8=True, calib=[img])
assert q8.model.quant.is_int8 and len(q8.model.quant.scales) > 100
qres = q8(img)
assert qres.masks[0].shape == (64, 64) and qres.xyxy[0].shape[1] == 6
f8, _ = build_model(cfg, fuse_focus=True, act_store="fp8")
f8.load_state_dict(sd, strict=False)
(dec8, _), seg8 = f8.eval()(torch.rand(1, 3, 64, 64))
assert torch.isfinite(dec8).all() and seg8.shape == (1, 2, 64, 64)

# another seg head (SegMaskBiSe) and the m config at full width, served
from desenet_tpu_torch.models.heads import (SegMaskBase, SegMaskBiSe,  # noqa
                                            SegMaskLab, SegMaskPSP)
from desenet_tpu_torch.models.layers import C3TR, FusedFocus  # noqa: F401
hcfg = json.loads(json.dumps(cfg))
hcfg["head"][-2] = [[16, 19, 22], 1, "SegMaskBiSe", ["se_nc", 1, 256]]
hsd = init_weights(build_model(hcfg)[0],
                   torch.Generator().manual_seed(0)).state_dict()
hres = Predictor(hcfg, hsd, imgsz=64, conf_thres=1e-3, half=False,
                 device="cpu")(img)
assert hres.masks[0].shape == (64, 64)
msd = init_weights(build_model(config_path("yolov5m_seg"))[0],
                   torch.Generator().manual_seed(0)).state_dict()
mpred = Predictor("yolov5m_seg", msd, imgsz=64, conf_thres=1e-3, half=False,
                  device="cpu")
assert mpred.spec.layers[0].name == "FusedFocus"
assert mpred(img).masks[0].shape == (64, 64)

# the served program through the port's own micro-batching runner
from desenet_tpu_torch.serve import _Pending
runner = BatchRunner(pred, max_batch=4, max_wait_ms=50.0)
runner.start()
reqs = [_Pending(img, want_mask=False) for _ in range(3)]
for r in reqs:
    assert runner.submit(r)
for r in reqs:
    assert r.done.wait(120) and r.error is None, r.error
runner.stop()
runner.join(10)
assert not runner.is_alive()
assert reqs[0].result["num"] == len(res.to_dicts()[0])
assert runner.stats["requests"] == 3, runner.stats

# the validation path: multi-label NMS, fused seg head, numpy metrics
val_model, _ = build_model(cfg, decode_cat=False, seg_head_fused=True)
val_model.load_state_dict(sd)
rng = np.random.default_rng(1)
batches = [{
    "image": rng.integers(0, 256, (2, 64, 64, 3), dtype=np.uint8),
    "det_targets": np.concatenate(
        [rng.integers(0, 3, (2, 4, 1)), rng.uniform(0.2, 0.8, (2, 4, 2)),
         rng.uniform(0.1, 0.3, (2, 4, 2))], -1).astype(np.float32),
    "det_mask": np.ones((2, 4), bool),
    "seg_labels": rng.integers(0, 2, (2, 64, 64), dtype=np.uint8),
    "shapes": [None, None],
} for _ in range(2)]
metrics = Validator(val_model, nc=3, se_nc=2).run(batches)
assert metrics["seen"] == 4 and 0 <= metrics["miou"] <= 1, metrics

# the training slice: two steps of the tiny model, the fused seg loss
from desenet_tpu_torch.train import create_train_state, make_train_step
from desenet_tpu_torch.train.engine import load_hyp, loss_and_schedule
train_model, tspec = build_model(cfg, seg_upsample=False, train=True)
train_model.load_state_dict(sd)
det_loss, opt_cfg, lf = loss_and_schedule(load_hyp(), tspec, 64, 10)
state = create_train_state(train_model, opt_cfg)
step = make_train_step(train_model, det_loss, opt_cfg, lf, nb=4,
                       warmup_iters=2, nominal_bs=2, batch_size=2,
                       fused_seg=True)
for _ in range(2):
    state, m = step(state, {k: batches[0][k] for k in (
        "image", "det_targets", "det_mask", "seg_labels")})
    assert np.isfinite(float(m["loss"])) and m["stepped"] == 1, m
assert (state.step, state.ema_updates) == (2, 2)

# the training engine's epoch loop on in-memory batches, checkpoints and all
import tempfile
with tempfile.TemporaryDirectory() as tmp:
    with open(tmp + "/tiny.json", "w") as fh:
        json.dump(cfg, fh)
    tcfg = engine.TrainConfig(cfg=tmp + "/tiny.json", epochs=1, batch_size=2, nbs=2,
                              imgsz=64, project=tmp, use_tb=False,
                              dtype="float32", warmup_floor=0, device="cpu")
    hyp = engine.load_hyp()
    save_dir = engine.make_run_dir(tcfg, hyp)
    loop = engine.build_loop(tcfg, hyp, 3, 2, 2, 64, "cpu", {"cfg": "tiny"},
                             save_dir)
    cbs = callbacks.Callbacks()
    cbs.auto_register(loggers.Loggers(save_dir, use_tb=False))
    fitted = engine.fit(tcfg, loop, [batches[0], batches[1]], batches[:1],
                        save_dir, cbs)
    assert fitted["seen"] == 2 and loop.state.step == 2, fitted
    last = checkpoint.load_checkpoint(save_dir + "/last")
    assert last["counters"]["step"] == 2 and last["meta"]["format"] == "torch"
    assert checkpoint.load_checkpoint(save_dir + "/best_stripped")["params"]
    with open(save_dir + "/opt.yaml") as fh:
        assert json.load(fh)["device"] == "cpu"

# the inference and validation slice: a checkpoint served through
# load_predictor, the detect program (K1, K2) plain, with TTA and on an
# ensemble, Validator with TTA on the ensemble, the COCO scorer, the plot
# targets and feature maps
from desenet_tpu_torch.api import load_predictor
from desenet_tpu_torch.cli import detect as cli_detect
from desenet_tpu_torch.eval.coco import evaluate_coco
from desenet_tpu_torch.eval.ensemble import EnsembleModel
from desenet_tpu_torch.utils import plots
with tempfile.TemporaryDirectory() as tmp:
    with open(tmp + "/tiny.json", "w") as fh:
        json.dump(cfg, fh)
    params, stats = checkpoint.split_stats(sd)
    checkpoint._write(tmp + "/ckpt", {"params": params, "batch_stats": stats},
                      {"cfg": tmp + "/tiny.json", "de_nc": 3, "se_nc": 2,
                       "de_names": ["a", "b", "c"], "se_names": ["x", "y"]})
    lp = load_predictor(tmp + "/ckpt", imgsz=64, conf_thres=1e-3, half=False,
                        device="cpu")
    lres = lp(img)
    assert np.array_equal(lres.xyxy[0], res.xyxy[0])
    assert lres.to_dicts()[0][0]["name"] in lp.names == ["a", "b", "c"]
    assert len(lres.xywhn[0]) == len(lres.tolist()[0].xyxy[0])
    det_model, _, meta = cli_detect.load_detector([tmp + "/ckpt"], False, "cpu")
    ens, _, _ = cli_detect.load_detector([tmp + "/ckpt"] * 2, False, "cpu")
    u8 = torch.from_numpy(img)[None]
    for m, aug in ((det_model, False), (det_model, True), (ens, True)):
        nms, seg_cls = cli_detect.detect_program(m, u8, 1e-3, augment=aug)
        assert seg_cls.shape == (1, 64, 64) and nms.boxes.shape[1] == 1000
    val_ens = EnsembleModel([val_model, val_model])
    em = Validator(val_ens, nc=3, se_nc=2, augment=True).run(batches)
    assert em["seen"] == 4, em
assert plots.output_to_target(nms).shape[1] == 7
assert len(plots.feature_maps(tiny, torch.rand(1, 3, 64, 64))) > 10
anno = {"images": [{"id": 1}], "categories": [{"id": 1}], "annotations": [
    {"id": 1, "image_id": 1, "category_id": 1, "bbox": [0, 0, 9, 9]}]}
pred_rec = [{"image_id": 1, "category_id": 1, "bbox": [0, 0, 9, 9],
             "score": 0.9}]
assert evaluate_coco(anno, pred_rec, quiet=True)[1] == 1.0

# the K5/K6 slice's entry points
import contextlib, io
for tool in (probe_stem_pallas, proto_c3_kernel):
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = tool.main(["--device", "cpu", "--batch", "1", "--imgsz", "64"])
    assert rc == 0 and "parity" in buf.getvalue(), buf.getvalue()
# the host data path's native library, built from csrc/host at first use
from desenet_tpu_torch import native
from desenet_tpu_torch.data.rasterize import rasterize_polygons_pil
assert native.available()
tiles = [np.full((4, 5, 3), i, np.uint8) for i in range(3)]
assert np.array_equal(native.assemble_batch(tiles), np.stack(tiles))
poly = [(1, np.array([[2, 2], [30, 4], [20, 28]], np.float32))]
assert np.array_equal(native.rasterize_polygons_native(poly, (32, 32)),
                      rasterize_polygons_pil(poly, (32, 32)))
if native.jpeg_available():
    from PIL import Image
    buf = io.BytesIO()
    Image.fromarray(np.zeros((48, 64, 3), np.uint8)).save(buf, "JPEG")
    dec, hw0 = native.decode_jpeg_scaled(buf.getvalue(), 32)
    assert hw0 == (48, 64) and dec.shape == (24, 32, 3), dec.shape

# a data-parallel step in two processes (gloo), the global batch's gradient
from desenet_tpu_torch.tools import dryrun_multichip
steps = dryrun_multichip.run(2, "cpu", fused=True, dtype=torch.float64,
                             steps=1, seed=0, b=4)
assert len(steps) == 1 and np.isfinite(steps[0][0]), steps[0][0]

# the training and deployment tooling: cli.log_dataset through the offline
# W&B backend (its yaml is JSON text), the serving export of a checkpoint
# and its consumer, profiling, the blocks the DSL cannot name
import os
from PIL import Image
from desenet_tpu_torch.cli import log_dataset
from desenet_tpu_torch.models import layers as L
from desenet_tpu_torch.tools import consume_exported_model, export_model
from desenet_tpu_torch.utils import profiling
with tempfile.TemporaryDirectory() as tmp:
    os.environ["WANDB_DIR"] = tmp + "/wandb"
    splits = {}
    for split in ("train", "val"):
        os.makedirs(f"{tmp}/ds/Images/{split}")
        Image.fromarray(img).save(f"{tmp}/ds/Images/{split}/a.jpg")
        splits[split] = f"{tmp}/ds/Images/{split}"
    with open(tmp + "/ds/data.yaml", "w") as fh:
        json.dump({**splits, "de": {"nc": 3, "names": ["a", "b", "c"]},
                   "se": {"nc": 2, "names": ["x", "y"]}}, fh)
    with contextlib.redirect_stdout(io.StringIO()):
        out = log_dataset.create_dataset_artifact(tmp + "/ds/data.yaml")
    with open(out) as fh:
        assert json.load(fh)["train"] == "wandb-artifact://train_dataset:latest"
    with open(tmp + "/tiny.json", "w") as fh:
        json.dump(cfg, fh)
    params, stats = checkpoint.split_stats(sd)
    checkpoint._write(tmp + "/ckpt", {"params": params, "batch_stats": stats},
                      {"cfg": tmp + "/tiny.json", "de_nc": 3, "se_nc": 2,
                       "de_names": ["a", "b", "c"], "se_names": ["x", "y"]})
    with contextlib.redirect_stdout(io.StringIO()):
        made = export_model.main([tmp + "/ckpt", tmp + "/m.pt2",
                                  "--img-size", "64", "--fp32", "--device",
                                  "cpu"])
    assert made["bytes"] > 0
    np.save(tmp + "/img.npy", img)
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        assert consume_exported_model.main([tmp + "/m.pt2",
                                            tmp + "/img.npy"]) == 0
    assert "seg class histogram" in buf.getvalue()
    del os.environ["WANDB_DIR"]
with contextlib.redirect_stdout(io.StringIO()):
    info = profiling.model_info(tiny, 64)
assert info["params"] == profiling.count_params(tiny)
assert L.DAPPM(8, 4, 8)(torch.rand(2, 8, 16, 16)).shape == (2, 8, 16, 16)

# the reference-checkpoint export and import, and the DSL fuzzer
from desenet_tpu_torch.tools import (export_torch_sd, fuzz_model_dsl,
                                     import_torch_ckpt)
with tempfile.TemporaryDirectory() as tmp:
    with open(tmp + "/tiny.json", "w") as fh:
        json.dump(cfg, fh)
    params, stats = checkpoint.split_stats(sd)
    checkpoint._write(tmp + "/ckpt", {"params": params, "batch_stats": stats},
                      {"cfg": tmp + "/tiny.json", "de_nc": 3, "se_nc": 2})
    with contextlib.redirect_stdout(io.StringIO()):
        export_torch_sd.main([tmp + "/ckpt", tmp + "/sd.npz"])
        with np.load(tmp + "/sd.npz") as z:
            torch.save({"ema": None, "model": {
                k: torch.from_numpy(z[k]) for k in z.files}},
                tmp + "/best.pt")
        import_torch_ckpt.main([tmp + "/best.pt", tmp + "/back", "--cfg",
                                tmp + "/tiny.json"])
        assert fuzz_model_dsl.run(50, seed=0) == []
    back = load_predictor(tmp + "/back", imgsz=64, conf_thres=1e-3,
                          half=False, device="cpu")
    assert np.array_equal(back(img).xyxy[0], res.xyxy[0])

loaded = sorted(m for m in sys.modules
                if m.split(".")[0] in {b.split(".")[0] for b in BLOCKED}
                | {"desenet_tpu"} and sys.modules[m] is not None)
assert not loaded, loaded
print("OK", len(res.to_dicts()[0]))
"""


def test_port_runs_without_jax_cv2_yaml():
    env = dict(os.environ)
    env.pop("PYTHONPATH", None)
    proc = subprocess.run([sys.executable, "-c", SCRIPT], cwd=ROOT, env=env,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert proc.stdout.startswith("OK"), proc.stdout


FORBIDDEN = {"desenet_tpu", "jax", "jaxlib", "flax", "optax", "orbax"}


def _imports(path):
    """Top-level names of every module a source file imports, wherever the
    import statement stands."""
    with open(path, encoding="utf-8") as fh:
        tree = ast.parse(fh.read(), path)
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name.split(".")[0], node.lineno
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield (node.module or "").split(".")[0], node.lineno


def test_port_sources_import_nothing_of_jax_or_the_jax_package():
    files = [os.path.join(ROOT, "chip_smoke.py")]
    for base, _, names in os.walk(os.path.join(ROOT, "desenet_tpu_torch")):
        files += [os.path.join(base, n) for n in names if n.endswith(".py")]
    assert len(files) > 30
    bad = [f"{os.path.relpath(f, ROOT)}:{line} imports {mod}"
           for f in files for mod, line in _imports(f) if mod in FORBIDDEN]
    assert not bad, bad
