"""Export a port checkpoint's weights as the reference's state dict (.npz).

    python -m desenet_tpu_torch.tools.export_torch_sd runs/train/exp/best \\
        sd.npz

Counterpart of ``tools/export_torch_sd.py``, which writes the same npz from
a JAX checkpoint. It reads the checkpoint directory's inference weights
(``utils/checkpoint.load_inference_variables``: the EMA where it has one)
and writes them under the reference's keys in float32, leaving out what
the reference either lacks or makes itself: the BNs that never run
(``DeSeNet.quirk_bn_keys``), the BN step counters and the Detect anchor
buffers. A fused stem (a Focus or FusedFocus row's 6x6 conv) goes back to
the Focus layout (``utils/convert.fused_to_focus``); C3 blocks are already
in the reference's ``cv1``/``cv2`` layout. The reference's model loads it
with

    sd = {k: torch.from_numpy(v) for k, v in np.load(path).items()}
    model.load_state_dict(sd, strict=False)   # never-run BNs keep their init

and ``tools/import_torch_ckpt.py`` goes the other way. The tool runs no
device work: it reads and writes CPU tensors.
"""

from __future__ import annotations

import argparse
from typing import Dict, Tuple

import numpy as np
import torch

from desenet_tpu_torch.models import config_path, parse_config
from desenet_tpu_torch.models.build import DeSeNet
from desenet_tpu_torch.utils.checkpoint import load_inference_variables
from desenet_tpu_torch.utils.convert import fused_to_focus

# the reference has no variable under these; the Detect anchors it builds
# from its own config
_DROPPED = ("num_batches_tracked", ".anchors", ".anchor_grid")


def export_state_dict(weights_dir: str
                      ) -> Tuple[Dict[str, np.ndarray], dict, object]:
    """(the reference-keyed float32 state dict, meta, spec) of the port
    checkpoint directory ``weights_dir``."""
    sd, meta = load_inference_variables(weights_dir)
    if meta is None:
        raise ValueError(f"{weights_dir}: checkpoint has no meta.json")
    spec = parse_config(config_path(meta["cfg"]), nc=meta["de_nc"],
                        se_nc=meta["se_nc"])
    with torch.device("meta"):
        quirk = set(DeSeNet(spec).quirk_bn_keys())
    out = {k: v.detach().to("cpu", torch.float32).numpy()
           for k, v in fused_to_focus(sd, spec).items()
           if k not in quirk and not k.endswith(_DROPPED)}
    return out, meta, spec


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("weights_dir", help="a port checkpoint directory")
    ap.add_argument("out_npz")
    args = ap.parse_args(argv)
    sd, meta, spec = export_state_dict(args.weights_dir)
    np.savez(args.out_npz, **sd)
    print(f"exported {len(sd)} tensors -> {args.out_npz} "
          f"(cfg={meta['cfg']}, de_nc={spec.de_nc}, se_nc={spec.se_nc})")
    return {"tensors": len(sd), "path": args.out_npz}


if __name__ == "__main__":
    main()
