"""Training CLI on the port.

    python -m desenet_tpu_torch.cli.train --data data.yaml --cfg yolov5s_seg \\
        --epochs 100 --batch-size 16 --img-size 640

The flags and defaults of ``desenet_tpu.cli.train``, plus ``--device``
(``cuda`` by default; ``--device cpu`` trains on the CPU, and nothing falls
back to it). A bare ``--resume`` finds the most recent ``last`` checkpoint
under the working directory and restores the run's ``opt.yaml``.

Several processes, one a device, train on one global batch (``--batch-size``
is global; ``train.engine`` says how the work is split):

- ``--n-devices N`` starts N processes on this host, process i on
  ``cuda:i`` (``--device cpu``: N processes on the CPU over gloo); it
  raises when the host has fewer cards;
- or each process is started by hand with the JAX package's environment::

    DESENET_COORDINATOR=host0:1234 DESENET_NUM_PROCESSES=2 \\
    DESENET_PROCESS_ID=0 python -m desenet_tpu_torch.cli.train ...

  where process i takes ``cuda:$LOCAL_RANK`` (``LOCAL_RANK`` defaults to
  the process id, for one host).

W&B (``train.engine`` says what each flag does; unless WANDB_MODE=online
the runs go to the port's offline backend, under the run directory, and
``wandb-artifact://`` references are looked up there and under WANDB_DIR)::

    python -m desenet_tpu_torch.cli.log_dataset --data data.yaml  # -> data_wandb.yaml
    python -m desenet_tpu_torch.cli.train --data data_wandb.yaml --wandb \\
        [--upload-dataset] [--bbox-interval N] [--artifact-alias A] \\
        [--entity E] [--remat]

``--remat`` recomputes each row's activations in the backward pass.
``--spatial k`` splits each image's height over k processes of a data
row (``--n-devices`` counts all of them: data x spatial; on one host),
for images too large for one device::

    python -m desenet_tpu_torch.cli.train ... --n-devices 4 --spatial 2

A size below 2 rows a process at the deepest stride is refused before
any process starts. ``--sync-bn`` is accepted and does nothing, as in
the JAX package: with several processes BN always takes the global
batch's statistics.
"""

from __future__ import annotations

import argparse
import dataclasses
import os
import sys

from desenet_tpu_torch.train.engine import TrainConfig, train
from desenet_tpu_torch.utils.general import set_logging


def _coerce_opt(v):
    """Parse stringified opt.yaml values back to python types (older runs
    saved every field through str(); new runs save real types)."""
    if isinstance(v, str):
        if v == "None":
            return None
        if v in ("True", "False"):
            return v == "True"
        for cast in (int, float):
            try:
                return cast(v)
            except ValueError:
                pass
    return v


def parse_opt(argv=None):
    p = argparse.ArgumentParser("desenet_tpu_torch train")
    p.add_argument("--data", type=str, required=True, help="dataset yaml")
    p.add_argument("--cfg", type=str, default="yolov5s_seg",
                   help="model config name or path")
    p.add_argument("--hyp", type=str, default=None, help="hyp yaml")
    p.add_argument("--weights", type=str, default="",
                   help="pretrain checkpoint dir")
    p.add_argument("--resume", type=str, nargs="?", const=True, default="",
                   help="checkpoint dir to resume; bare --resume finds the "
                        "most recent run and restores its opt.yaml")
    p.add_argument("--epochs", type=int, default=300)
    p.add_argument("--batch-size", type=int, default=16)
    p.add_argument("--img-size", "--imgsz", type=int, default=640)
    p.add_argument("--workers", type=int, default=8)
    p.add_argument("--project", type=str, default="runs/train")
    p.add_argument("--name", type=str, default="exp")
    p.add_argument("--exist-ok", action="store_true")
    p.add_argument("--single-cls", action="store_true")
    p.add_argument("--adam", action="store_true")
    p.add_argument("--linear-lr", action="store_true")
    p.add_argument("--label-smoothing", type=float, default=0.0)
    p.add_argument("--patience", type=int, default=30)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--max-targets", type=int, default=128)
    p.add_argument("--noval", action="store_true")
    p.add_argument("--nosave", action="store_true")
    p.add_argument("--save-period", "--save_period", type=int, default=-1)
    p.add_argument("--det-gain", type=float, default=0.14,
                   help="detection loss gain")
    p.add_argument("--seg-gain", type=float, default=1.0)
    p.add_argument("--dtype", type=str, default="bfloat16",
                   choices=["bfloat16", "float32"],
                   help="compute dtype (autocast); parameters stay float32")
    p.add_argument("--device", type=str, default="cuda",
                   help="cuda (default) or cpu")
    p.add_argument("--n-devices", type=int, default=None,
                   help="train in this many processes on this host, one a "
                        "device")
    p.add_argument("--spatial", type=int, default=1,
                   help="spatial-partitioning factor: split image height "
                        "over this many processes (devices = data x "
                        "spatial)")
    p.add_argument("--no-tb", action="store_true")
    p.add_argument("--noautoanchor", action="store_true")
    p.add_argument("--multi-scale", action="store_true")
    p.add_argument("--image-weights", action="store_true")
    p.add_argument("--nbs", type=int, default=64,
                   help="nominal batch size for grad accumulation")
    p.add_argument("--warmup-floor", type=int, default=1000,
                   help="minimum warmup iterations")
    p.add_argument("--remat", action="store_true",
                   help="recompute each row's activations in the backward "
                        "pass (activation checkpointing)")
    p.add_argument("--wandb", action="store_true",
                   help="log to W&B (the offline backend without wandb)")
    p.add_argument("--upload-dataset", "--upload_dataset",
                   action="store_true",
                   help="log the dataset splits as W&B artifacts")
    p.add_argument("--entity", type=str, default=None, help="W&B entity")
    p.add_argument("--bbox-interval", "--bbox_interval", type=int, default=-1,
                   help="W&B media panel every N epochs (-1: epochs // 10)")
    p.add_argument("--artifact-alias", "--artifact_alias", type=str,
                   default="latest",
                   help="version of the wandb-artifact:// dataset splits")
    p.add_argument("--sync-bn", action="store_true",
                   help="accepted for compatibility; BN statistics are "
                        "always the global batch's")
    p.add_argument("--fast-decode", action="store_true",
                   help="scaled JPEG decode of the training images (native "
                        "libjpeg; not pixel-equal to PIL, val keeps PIL)")
    p.add_argument("--rect", action="store_true",
                   help="rectangular training (aspect-sorted batch shapes)")
    p.add_argument("--quad", action="store_true",
                   help="quad collate (4 images -> 2x2 super-image or "
                        "2x upscale)")
    p.add_argument("--freeze", type=int, default=0,
                   help="freeze first N layers")
    p.add_argument("--no-fused-seg-loss", action="store_true",
                   help="materialize full-res seg logits for the CE loss "
                        "instead of the tiled upsample+CE")
    p.add_argument("--cache-images", choices=("ram", "disk"), default=None,
                   help="decode and resize each training image once: 'ram' "
                        "keeps the arrays, 'disk' writes memory-mapped .npy "
                        "files")
    return p.parse_args(argv)


def process_device(device: str, local_rank: int) -> str:
    """The device of the process of ``local_rank`` on its host: a bare
    ``cuda`` becomes ``cuda:<local_rank>``; an explicit index or the CPU
    stays."""
    return f"cuda:{local_rank}" if device == "cuda" else device


def _maybe_init_multihost(device: str) -> str:
    """Join the process group when the environment names one (the JAX
    CLI's DESENET_COORDINATOR, DESENET_NUM_PROCESSES, DESENET_PROCESS_ID);
    returns this process's device."""
    coord = os.environ.get("DESENET_COORDINATOR")
    if not coord:
        return device
    from desenet_tpu_torch.parallel.multihost import init_multihost

    try:
        n = int(os.environ["DESENET_NUM_PROCESSES"])
        pid = int(os.environ["DESENET_PROCESS_ID"])
    except (KeyError, ValueError) as e:
        raise ValueError(
            "DESENET_COORDINATOR needs DESENET_NUM_PROCESSES and "
            f"DESENET_PROCESS_ID as integers ({e})") from None
    device = process_device(device, int(os.environ.get("LOCAL_RANK", pid)))
    init_multihost(coord, n, pid, device=device)
    return device


def _spawned(rank: int, n: int, coordinator: str, argv) -> dict:
    """One of ``--n-devices``' processes: ``main`` under the environment
    launch."""
    os.environ.update(DESENET_COORDINATOR=coordinator,
                      DESENET_NUM_PROCESSES=str(n),
                      DESENET_PROCESS_ID=str(rank), LOCAL_RANK=str(rank))
    return main(argv)


def launch(n: int, device: str, argv) -> dict:
    """Train in ``n`` processes on this host (``--n-devices``), process i on
    ``cuda:i`` or the CPU; returns process 0's results."""
    import torch

    from desenet_tpu_torch.parallel.multihost import spawn

    cards = torch.cuda.device_count() if torch.cuda.is_available() else 0
    if device.startswith("cuda") and cards < n:
        raise RuntimeError(f"--n-devices {n}: this host has {cards} CUDA "
                           "card(s)")
    return spawn(_spawned, n, argv)


def check_spatial_launch(o) -> None:
    """Refuse a ``--spatial`` run's sizes before its processes start: the
    mesh's layout (``make_mesh`` outside a group) against the config's
    deepest stride, as ``train.engine`` checks it again in each."""
    from desenet_tpu_torch.models import config_path
    from desenet_tpu_torch.models.build import parse_config
    from desenet_tpu_torch.parallel.mesh import make_mesh
    from desenet_tpu_torch.train.engine import check_mesh_size
    from desenet_tpu_torch.utils.general import check_img_size

    stride = int(max(parse_config(config_path(o.cfg)).det_strides))
    cfg = TrainConfig(spatial=o.spatial, multi_scale=o.multi_scale)
    check_mesh_size(cfg, make_mesh(o.n_devices, spatial=o.spatial),
                    check_img_size(o.img_size, s=stride), stride)


def main(argv=None, callbacks=None):
    """Parse ``argv`` and train; ``callbacks`` (``utils.callbacks``) gets
    the engine's hooks beside the loggers (one process only)."""
    set_logging()
    o = parse_opt(argv)
    if (o.n_devices or 1) > 1 and not os.environ.get("DESENET_COORDINATOR"):
        if callbacks is not None:
            raise ValueError("callbacks cannot cross into --n-devices' "
                             "processes")
        if o.spatial > 1:
            check_spatial_launch(o)
        return launch(o.n_devices, o.device,
                      sys.argv[1:] if argv is None else list(argv))
    o.device = _maybe_init_multihost(o.device)
    overrides = None
    if o.resume is True:
        # bare --resume: the most recent run, with its own options; an
        # explicit --resume PATH keeps this invocation's flags
        from desenet_tpu_torch.utils.general import get_latest_run, load_yaml

        o.resume = get_latest_run()
        if not o.resume:
            raise FileNotFoundError("--resume: no previous run found under ./")
        print(f"resuming most recent run: {o.resume}")
        opt_yaml = os.path.join(os.path.dirname(os.path.abspath(o.resume)),
                                "opt.yaml")
        if os.path.isfile(opt_yaml):
            saved = load_yaml(opt_yaml) or {}
            fields = {f.name for f in dataclasses.fields(TrainConfig)}
            overrides = {k: _coerce_opt(v) for k, v in saved.items()
                         if k in fields}
            overrides.update(resume=o.resume, exist_ok=True)
    cfg = TrainConfig(
        data=o.data, cfg=o.cfg, hyp=o.hyp, weights=o.weights, resume=o.resume,
        epochs=o.epochs, batch_size=o.batch_size, imgsz=o.img_size,
        workers=o.workers, project=o.project, name=o.name,
        exist_ok=o.exist_ok, single_cls=o.single_cls, adam=o.adam,
        linear_lr=o.linear_lr, label_smoothing=o.label_smoothing,
        patience=o.patience, seed=o.seed, max_targets=o.max_targets,
        noval=o.noval, nosave=o.nosave, save_period=o.save_period,
        det_gain=o.det_gain, seg_gain=o.seg_gain, dtype=o.dtype,
        n_devices=o.n_devices, spatial=o.spatial, use_tb=not o.no_tb,
        noautoanchor=o.noautoanchor, multi_scale=o.multi_scale,
        image_weights=o.image_weights, nbs=o.nbs,
        warmup_floor=o.warmup_floor, remat=o.remat, wandb=o.wandb,
        upload_dataset=o.upload_dataset, fast_decode=o.fast_decode,
        cache_images=o.cache_images, rect=o.rect, quad=o.quad,
        freeze=o.freeze, entity=o.entity, bbox_interval=o.bbox_interval,
        artifact_alias=o.artifact_alias,
        fused_seg_loss=not o.no_fused_seg_loss, device=o.device,
    )
    if overrides:
        cfg = dataclasses.replace(cfg, **overrides)
    try:
        results = train(cfg, callbacks)
    finally:
        if os.environ.get("DESENET_COORDINATOR"):
            from desenet_tpu_torch.parallel.multihost import shutdown

            shutdown()
    print(f"done: save_dir={results['save_dir']} "
          f"best_fitness={results['best_fitness']:.4f}")
    return results


if __name__ == "__main__":
    main()
