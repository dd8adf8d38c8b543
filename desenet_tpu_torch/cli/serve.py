"""Serving CLI: micro-batching HTTP inference server on the port.

    python -m desenet_tpu_torch.cli.serve --weights runs/train/exp/best
    python -m desenet_tpu_torch.cli.serve --cfg yolov5s_seg --state-dict sd.npz
    python -m desenet_tpu_torch.cli.serve --cfg yolov5s_seg --seed 0

``--weights`` is a checkpoint directory, as the JAX CLI's is: the port's
``cli.train`` writes them, and ``api.load_predictor`` serves its EMA with
the names, class counts and anchors of its meta.json. The port adds two
sources of its own, each built from ``--cfg``: ``--state-dict``, a
torch-named state dict saved with ``np.savez`` (``tools/export_torch_sd.py``
writes one from a JAX checkpoint), and ``--seed``, random weights made from
that seed. ``--int8 --calib-dir DIR`` serves the int8 W8A8 program,
calibrated on up to 16 images of DIR, as the JAX CLI's. ``--n-devices N``
serves each micro-batch over N cards (``Predictor(n_devices=N)``: a
replica a card, the batch padded to a multiple of N); ``--no-bake-weights``
is the JAX CLI's flag, accepted and without effect (eager PyTorch holds
one weight copy a replica either way). POST image bytes
to /predict (add ?mask=1 for the base64-PNG class mask); GET /healthz and
/info for liveness and model metadata.
"""

from __future__ import annotations

import argparse
import glob
import logging
import os

import torch

from desenet_tpu_torch.api import Predictor, load_predictor
from desenet_tpu_torch.models import build_model, config_path, init_weights
from desenet_tpu_torch.serve import InferenceServer
from desenet_tpu_torch.utils.convert import load_npz_state_dict


def parse_opt(argv=None):
    parser = argparse.ArgumentParser(description=__doc__)
    src = parser.add_mutually_exclusive_group(required=True)
    src.add_argument("--weights",
                     help="checkpoint directory (meta.json + state.pt)")
    src.add_argument("--state-dict",
                     help="torch-named state dict (.npz) of --cfg")
    src.add_argument("--seed", type=int,
                     help="serve random weights of --cfg made from this seed")
    parser.add_argument("--cfg", default="yolov5s_seg",
                        help="bundled config name or .json/.yaml path, for "
                             "--state-dict and --seed")
    parser.add_argument("--device", default="cuda")
    parser.add_argument("--host", default="127.0.0.1",
                        help="bind address; the endpoint is unauthenticated, "
                             "so pass 0.0.0.0 explicitly to expose it")
    parser.add_argument("--port", type=int, default=8000)
    parser.add_argument("--img-size", type=int, default=640)
    parser.add_argument("--conf-thres", type=float, default=0.25)
    parser.add_argument("--iou-thres", type=float, default=0.45)
    parser.add_argument("--max-det", type=int, default=300)
    parser.add_argument("--max-batch", type=int, default=16,
                        help="micro-batch cap (largest batch bucket)")
    parser.add_argument("--max-wait-ms", type=float, default=5.0,
                        help="how long a request waits for batch-mates")
    parser.add_argument("--max-queue", type=int, default=None,
                        help="queue bound before 503 shedding "
                             "(default 4x max-batch)")
    parser.add_argument("--max-body-mb", type=float, default=32.0,
                        help="largest accepted request body (413 above)")
    parser.add_argument("--no-half", action="store_true",
                        help="run float32 instead of bfloat16")
    parser.add_argument("--n-devices", type=int, default=1,
                        help="shard each micro-batch over this many cards "
                             "(a replica a card; batch pads to a multiple)")
    parser.add_argument("--no-bake-weights", action="store_true",
                        help="the JAX CLI's shared-weights option, "
                             "accepted and without effect: the port holds "
                             "one weight copy a replica either way")
    parser.add_argument("--int8", action="store_true",
                        help="serve the int8 W8A8 quantized model; needs "
                             "--calib-dir")
    parser.add_argument("--calib-dir", default=None,
                        help="directory of representative images for int8 "
                             "activation calibration (a handful suffices)")
    args = parser.parse_args(argv)
    if args.int8:
        if not args.calib_dir:
            parser.error("--int8 needs --calib-dir")
        args.calib = sorted(
            p for p in glob.glob(os.path.join(args.calib_dir, "*"))
            if p.lower().endswith((".jpg", ".jpeg", ".png", ".bmp")))[:16]
        if not args.calib:
            parser.error(f"no images found in {args.calib_dir}")
    return args


def build_predictor(args) -> Predictor:
    """The ``Predictor`` that ``main`` serves, from the parsed options."""
    kw = dict(imgsz=args.img_size, conf_thres=args.conf_thres,
              iou_thres=args.iou_thres, max_det=args.max_det,
              half=not args.no_half, device=args.device,
              n_devices=args.n_devices,
              bake_weights=not args.no_bake_weights)
    if args.int8:
        kw.update(int8=True, calib=args.calib)
    if args.weights:
        return load_predictor(args.weights, **kw)
    cfg = config_path(args.cfg)
    if args.state_dict:
        sd = load_npz_state_dict(args.state_dict)
    else:
        model, _ = build_model(cfg)
        sd = init_weights(model, torch.Generator().manual_seed(args.seed)
                          ).state_dict()
    return Predictor(cfg, sd, **kw)


def main(argv=None):
    args = parse_opt(argv)
    logging.basicConfig(level=logging.INFO, format="%(message)s")
    predictor = build_predictor(args)
    server = InferenceServer(predictor, host=args.host, port=args.port,
                             max_batch=args.max_batch,
                             max_wait_ms=args.max_wait_ms,
                             max_queue=args.max_queue,
                             max_body_bytes=int(args.max_body_mb * 1024 * 1024))
    source = (args.weights or f"{args.cfg} from "
              + (args.state_dict or f"seed {args.seed}"))
    logging.info("serving %s on http://%s:%d (max_batch=%d, max_wait=%sms)",
                 source, args.host, server.port, args.max_batch,
                 args.max_wait_ms)
    try:
        server.serve_forever()
    except KeyboardInterrupt:
        pass


if __name__ == "__main__":
    main()
