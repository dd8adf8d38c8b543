"""Import a reference (splwany/DeSeNet) PyTorch checkpoint into a port
checkpoint directory.

    python -m desenet_tpu_torch.tools.import_torch_ckpt best.pt out_dir \\
        --cfg yolov5s_seg [--ref-root DIR] [--de-names ...] [--se-names ...]

Counterpart of ``tools/import_torch_ckpt.py``, which writes a JAX (orbax)
checkpoint. The reference pickles its whole ``nn.Module``, so unpickling
needs the reference's code importable: ``--ref-root`` puts a DeSeNet
checkout first on ``sys.path``. The weights are the checkpoint's ``ema``,
else its ``model``, else the object itself (the reference's
``attempt_load`` prefers the EMA); a module gives its ``state_dict()``, a
mapping of tensors is one already, and every tensor is taken in float32
(the reference saves its EMA and model in half).

They load into the port model of ``--cfg`` (a bundled name or a path)
through ``utils/convert.load_state_dict``, which lets only the BNs that
never run and the training-only modules be missing, and drops the Detect
``anchors``/``anchor_grid`` buffers: the model takes its anchors from the
config, as the JAX package's import does. Where the checkpoint's anchors
differ from the config's, one line says so and nothing changes. The
directory is written as a stripped checkpoint (``params`` and
``batch_stats``; ``utils/checkpoint.py``) with meta.json's ``cfg``,
``imgsz`` 640, ``de_nc``, ``se_nc``, class names and ``source``, so
``api.load_predictor(out_dir)`` serves it. The tool runs no device work:
it reads and writes CPU tensors.
"""

from __future__ import annotations

import argparse
import os
import sys
from typing import Dict, Mapping, Optional

import torch

from desenet_tpu_torch.models import build_model, config_path
from desenet_tpu_torch.train.state import bn_stats, trainable
from desenet_tpu_torch.utils.checkpoint import _write
from desenet_tpu_torch.utils.convert import load_state_dict

_ANCHOR_TOL = 1e-3  # relative and absolute (px): the anchors may be half


def reference_state_dict(obj) -> Dict[str, torch.Tensor]:
    """The float32 weights of a loaded reference checkpoint: its ``ema``,
    else its ``model``, else ``obj`` itself; a module's ``state_dict()``,
    or a mapping of tensors as it is."""
    if isinstance(obj, Mapping):
        obj = next((obj[k] for k in ("ema", "model")
                    if obj.get(k) is not None), obj)
    sd = obj.state_dict() if isinstance(obj, torch.nn.Module) else obj
    return {k: v.float() for k, v in sd.items()}


def anchors_note(sd: Mapping[str, torch.Tensor], spec) -> Optional[str]:
    """A line saying how the checkpoint's Detect anchors (grid units times
    the strides) differ from ``spec``'s, or None where they agree or the
    checkpoint has none."""
    a = sd.get(f"model.{spec.det_layer}.anchors")
    if a is None:
        return None
    strides = torch.tensor(spec.det_strides, dtype=torch.float32)
    px = a.reshape(len(spec.det_strides), -1, 2) * strides.view(-1, 1, 1)
    want = torch.tensor(spec.anchors, dtype=torch.float32).reshape(px.shape)
    if torch.allclose(px, want, rtol=_ANCHOR_TOL, atol=_ANCHOR_TOL):
        return None
    return (f"anchors: the checkpoint's {px.reshape(len(strides), -1).tolist()}"
            f" px differ from the config's "
            f"{want.reshape(len(strides), -1).tolist()}; the config's are "
            "served (as by the JAX package's import)")


def import_checkpoint(pt_path: str, out_dir: str, cfg: str = "yolov5s_seg",
                      de_names=None, se_names=None) -> dict:
    """Read the reference checkpoint ``pt_path``, load it into the port
    model of ``cfg`` and write the checkpoint directory ``out_dir``;
    returns the meta written."""
    ckpt = torch.load(pt_path, map_location="cpu", weights_only=False)
    sd = reference_state_dict(ckpt)
    model, spec = build_model(config_path(cfg))
    load_state_dict(model, sd)
    unused = sorted(set(sd) - set(model.state_dict()))
    print(f"converted; {len(unused)} unused torch keys (expected: Detect "
          "anchor buffers)")
    note = anchors_note(sd, spec)
    if note:
        print(note)
    meta = {
        "cfg": cfg,
        "imgsz": 640,
        "de_nc": spec.de_nc,
        "se_nc": spec.se_nc,
        "de_names": de_names or [str(i) for i in range(spec.de_nc)],
        "se_names": se_names or [str(i) for i in range(spec.se_nc)],
        "source": os.path.abspath(pt_path),
    }
    payload = {k: {n: t.detach().clone() for n, t in d.items()}
               for k, d in (("params", trainable(model)),
                            ("batch_stats", bn_stats(model)))}
    _write(os.path.abspath(out_dir), payload, meta)
    print(f"saved {out_dir}")
    return meta


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("pt_path")
    ap.add_argument("out_dir")
    ap.add_argument("--cfg", default="yolov5s_seg",
                    help="the matching port model config: a bundled name "
                         "or a path")
    ap.add_argument("--ref-root", default=None,
                    help="a reference DeSeNet checkout, to unpickle its "
                         "modules")
    ap.add_argument("--de-names", nargs="*", default=None)
    ap.add_argument("--se-names", nargs="*", default=None)
    args = ap.parse_args(argv)
    if args.ref_root:
        sys.path.insert(0, args.ref_root)
    return import_checkpoint(args.pt_path, args.out_dir, args.cfg,
                             args.de_names, args.se_names)


if __name__ == "__main__":
    main()
