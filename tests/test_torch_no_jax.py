"""desenet_tpu_torch imports, serves, validates (on an in-memory loader)
and runs its kernel probes (K5, K6), its profiler importing, with JAX, flax, optax, orbax, cv2 and
PyYAML blocked: the port never needs JAX, and the card's machine may lack
cv2 and PyYAML."""

import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

SCRIPT = r"""
import sys
BLOCKED = ("jax", "jaxlib", "flax", "optax", "orbax", "orbax.checkpoint",
           "cv2", "yaml")
for m in BLOCKED:
    sys.modules[m] = None  # any import of these raises ImportError

import json
import numpy as np
import torch

import desenet_tpu_torch
from desenet_tpu_torch.api import Predictor
from desenet_tpu_torch.cli import serve as cli_serve  # noqa: F401
from desenet_tpu_torch.cli import show_seg_miou, val as cli_val  # noqa: F401
from desenet_tpu_torch.eval import Validator
from desenet_tpu_torch.models import build_model, config_path, init_weights
from desenet_tpu_torch.ops import c3_fused, stem_pallas  # noqa: F401
from desenet_tpu_torch.serve import BatchRunner, InferenceServer  # noqa: F401
from desenet_tpu_torch.tools import probe_stem_pallas, proto_c3_kernel
from desenet_tpu_torch.tools import profile_served  # noqa: F401
from desenet_tpu_torch.utils import fold  # noqa: F401

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

# the K5/K6 slice's entry points
import contextlib, io
for tool in (probe_stem_pallas, proto_c3_kernel):
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = tool.main(["--device", "cpu", "--batch", "1", "--imgsz", "64"])
    assert rc == 0 and "parity" in buf.getvalue(), buf.getvalue()
loaded = sorted(m for m in sys.modules
                if m.split(".")[0] in {b.split(".")[0] for b in BLOCKED}
                and sys.modules[m] is not None)
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
