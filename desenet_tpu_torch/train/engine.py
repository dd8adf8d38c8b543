"""The training engine: set-up, epoch loop, validation of the EMA weights,
checkpoints.

Counterpart of ``desenet_tpu/train/engine.py``: one process on one
device, or several processes, one a device, in the process group of
``parallel.multihost`` (``cli/train.py`` starts them). ``train(cfg)`` keeps
the JAX engine's order: the run directory
(``hyp.yaml``, ``opt.yaml``), the dataset check, the augmented training
loader and the rect validation loader, the class weights, the autoanchor
gate (a rebuild on new anchors), the loss gains and the schedule
(``loss_and_schedule``), the model and its ``TrainState`` from a seed, a
resumed checkpoint or a ``--weights`` transfer, the training step and the
eval twin with full-resolution seg logits for ``Validator``. Then ``fit``
runs the epochs: training steps, the EMA weights through ``Validator`` at
every epoch end (or only the last with ``noval``), the ``fitness_det_seg``
row through the callbacks (``results.csv``), ``last``/``best``/``epoch{N}``
checkpoints, early stopping and ``best_stripped`` at the end.

``fit`` takes any iterable of batches (re-iterated every epoch;
``set_epoch(epoch)`` is called where it has one), so a caller can drive
the loop on batches already on the device. The per-batch losses stay on
the device and are read at the log ticks, four an epoch: the loop makes no
host round trip per batch. The engine runs where ``cfg.device`` says
(``cuda`` by default) and raises if that device is absent.

With several processes, as in the JAX engine: the global batch divides
by the process count and each process loads a strided shard of every
epoch (``loader.py``'s rank/world_size), ``--quad`` needs the per-process
batch to divide by 4, ``--rect`` is refused; process 0 owns the run
directory, ``opt.yaml``/``hyp.yaml``, ``results.csv``, plots, checkpoints
and the EMA validation, and sends the others the run directory and each
epoch's fitness; the processes meet at the dataset cache, each epoch's
checkpoints and the end. The step takes the gradient of the global batch's
loss with BN over the global batch (``train/step.py``).

``--wandb`` (process 0 only, as in the JAX engine): a ``WandbLogger``
(``utils/wandb_logger.py``: the port's offline backend unless
WANDB_MODE=online) on the callbacks, with ``--bbox-interval`` -1 resolved
to ``epochs // 10`` (1 up to 10 epochs); ``wandb-artifact://`` dataset
splits (at ``--artifact-alias``), ``--resume`` and ``--weights`` resolved
before the path checks (and sent to the other processes); with
``--upload-dataset`` the splits logged as dataset artifacts; after each
save ``last`` logged into the model artifact ``run_<id>_model`` with the
aliases ``latest``, ``last``, ``epoch N`` and, for the best epoch,
``best``. ``--remat`` recomputes each DSL row's activations in the
backward pass (``models/build.py``).

``--spatial k`` (the JAX engine's data x spatial mesh): the processes
form an ``n_data x k`` grid (``parallel.mesh.make_mesh``; ``--n-devices
N`` starts N = n_data x k of them), the global batch divides over the
data axis only, and the k processes of a data row load the same shard
and each trains on its height band of it (``train/step.py``).
``check_spatial`` holds the smallest size the run feeds (multi-scale's
0.5x floor) to 2 rows per band at the deepest stride, and the run must
stay on one host. The EMA validation runs as in the JAX engine, where it
is one device's program outside the mesh: process 0 validates the whole
val batches on its own device, the model unsharded (kernel K3's NMS on a
card), and sends the others the fitness.
"""

from __future__ import annotations

import dataclasses
import json
import logging
import math
import os
import time
from dataclasses import dataclass
from typing import Callable, Dict, Iterable, Optional, Tuple

import numpy as np
import torch

from desenet_tpu_torch.losses import DetectionLoss
from desenet_tpu_torch.models import build_model, config_path, init_weights
from desenet_tpu_torch.models.heads import anchors_grid_units
from desenet_tpu_torch.parallel import multihost
from desenet_tpu_torch.parallel.mesh import (Mesh, check_spatial,
                                             make_mesh, process_count,
                                             process_index)
from desenet_tpu_torch.train.optim import OptimConfig
from desenet_tpu_torch.train.schedule import linear_lr as _linear_lr
from desenet_tpu_torch.train.schedule import one_cycle
from desenet_tpu_torch.train.state import TrainState, create_train_state
from desenet_tpu_torch.train.step import make_train_step
from desenet_tpu_torch.utils.callbacks import Callbacks

LOGGER = logging.getLogger("desenet_tpu_torch")

HYP_PATH = os.path.join(os.path.dirname(os.path.dirname(__file__)),
                        "configs", "hyp_scratch.json")

# the reference recipe (configs/hyp_scratch.json, the --hyp file users edit)
DEFAULT_HYP = dict(
    lr0=0.01, lrf=0.2, momentum=0.937, weight_decay=0.0005,
    warmup_epochs=3.0, warmup_momentum=0.8, warmup_bias_lr=0.1,
    box=0.05, cls=0.5, cls_pw=1.0, obj=0.7, obj_pw=1.0,
    iou_t=0.2, anchor_t=4.0, fl_gamma=0.0,
    hsv_h=0.05, hsv_s=0.2, hsv_v=0.1,
    degrees=0.0, translate=0.1, scale=0.2, shear=0.0, perspective=0.0,
    flipud=0.0, fliplr=0.5, mosaic=1.0, mixup=0.0,
)

LOSS_KEYS = ("lbox", "lobj", "lcls", "lseg")
BATCH_KEYS = ("image", "det_targets", "det_mask", "seg_labels")


@dataclass
class TrainConfig:
    data: str = ""  # dataset yaml
    cfg: str = "yolov5s_seg"  # model config name/path
    hyp: Optional[str] = None  # hyp yaml path (None -> DEFAULT_HYP)
    weights: str = ""  # pretrain checkpoint dir ('' = from scratch)
    epochs: int = 300
    batch_size: int = 16
    imgsz: int = 640
    workers: int = 8
    project: str = "runs/train"
    name: str = "exp"
    exist_ok: bool = False
    single_cls: bool = False
    adam: bool = False
    linear_lr: bool = False
    label_smoothing: float = 0.0
    patience: int = 30
    seed: int = 0
    max_targets: int = 128
    noval: bool = False
    nosave: bool = False
    save_period: int = -1
    det_gain: float = 0.14  # the reference's detgain
    seg_gain: float = 1.0
    resume: str = ""  # checkpoint dir to resume from
    dtype: str = "bfloat16"  # compute dtype (autocast); parameters stay f32
    n_devices: Optional[int] = None
    use_tb: bool = True
    noautoanchor: bool = False
    multi_scale: bool = False  # random 0.5-1.5x size buckets per batch
    image_weights: bool = False  # class-weighted image resampling per epoch
    nbs: int = 64  # nominal batch size for gradient accumulation
    warmup_floor: int = 1000  # least warmup iterations
    remat: bool = False
    wandb: bool = False
    upload_dataset: bool = False
    entity: Optional[str] = None
    bbox_interval: int = -1
    artifact_alias: str = "latest"
    fast_decode: bool = False
    cache_images: Optional[str] = None
    rect: bool = False  # aspect-sorted batch shapes (no mosaic, no shuffle)
    quad: bool = False  # quad collate: groups of 4 -> one 2x-size image
    freeze: int = 0  # freeze the first N layers
    spatial: int = 1  # processes of a data row, each on a height band
    fused_seg_loss: bool = True  # 1/8 seg logits, CE of their 8x upsample
    # by row blocks (ops/seg_ce.py), the JAX engine's default
    device: str = "cuda"  # where the model trains; "cpu" only when asked


def load_hyp(path: Optional[str] = None) -> Dict:
    """``DEFAULT_HYP`` updated from the yaml (or JSON) file ``path``."""
    from desenet_tpu_torch.utils.general import load_yaml

    hyp = dict(DEFAULT_HYP)
    if path:
        hyp.update(load_yaml(path))
    return hyp


def loss_and_schedule(hyp: Dict, spec, imgsz: int, epochs: int,
                      linear_lr: bool = False, adam: bool = False,
                      label_smoothing: float = 0.0
                      ) -> Tuple[DetectionLoss, OptimConfig, Callable]:
    """(DetectionLoss, OptimConfig, lf) for ``spec`` at ``imgsz``, with the
    loss gains scaled as train.py:258-260 scales them."""
    nl = len(spec.det_strides)
    anchors = anchors_grid_units(spec.layers[spec.det_layer].args[1],
                                 spec.det_strides)
    det_loss = DetectionLoss(
        anchors=tuple(tuple(tuple(float(v) for v in a) for a in s)
                      for s in anchors),
        nc=spec.de_nc,
        box_gain=hyp["box"] * 3.0 / nl,
        obj_gain=hyp["obj"] * (imgsz / 640.0) ** 2 * 3.0 / nl,
        cls_gain=hyp["cls"] * spec.de_nc / 80.0 * 3.0 / nl,
        cls_pw=hyp["cls_pw"], obj_pw=hyp["obj_pw"],
        label_smoothing=label_smoothing, fl_gamma=hyp["fl_gamma"],
        anchor_t=hyp["anchor_t"],
    )
    opt_cfg = OptimConfig(
        optimizer="adam" if adam else "sgd",
        lr0=hyp["lr0"], momentum=hyp["momentum"],
        weight_decay=hyp["weight_decay"],
        warmup_bias_lr=hyp["warmup_bias_lr"],
        warmup_momentum=hyp["warmup_momentum"],
    )
    lf = (_linear_lr(hyp["lrf"], epochs) if linear_lr
          else one_cycle(1.0, hyp["lrf"], epochs))
    return det_loss, opt_cfg, lf


def resolve_device(name: str) -> torch.device:
    """``name`` as a device; a CUDA one must exist (no quiet CPU run). A
    bare ``cuda`` is the process's current card (``cuda:LOCAL_RANK`` in a
    multi-process run, ``init_multihost`` sets it)."""
    dev = torch.device(name)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"--device {name}: torch finds no CUDA device; "
                           "pass --device cpu to train on the CPU")
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    return dev


def check_processes(cfg: TrainConfig, pc: int) -> None:
    """The JAX engine's conditions on a run of ``pc`` processes, of which
    ``pc // spatial`` data ranks split the batch."""
    if cfg.n_devices not in (None, 1) and cfg.n_devices != pc:
        raise ValueError(
            f"--n-devices {cfg.n_devices} trains in {cfg.n_devices} "
            f"processes, one a device, and this run has {pc}: cli.train "
            "starts them, or launch them with DESENET_COORDINATOR, "
            "DESENET_NUM_PROCESSES and DESENET_PROCESS_ID")
    sp = max(cfg.spatial, 1)
    if pc % sp:
        raise ValueError(
            f"--spatial {sp} must divide the device count ({pc})")
    n_dp = pc // sp
    if cfg.batch_size % n_dp:
        raise ValueError(f"global batch {cfg.batch_size} not divisible by "
                         f"{n_dp} processes")
    if cfg.quad and (cfg.batch_size // n_dp) % 4:
        raise ValueError(
            f"--quad needs the per-process batch ({cfg.batch_size}/{n_dp}="
            f"{cfg.batch_size // n_dp}) divisible by 4 (collate groups 4 "
            "images per super-image)")
    if pc == 1:
        return
    if cfg.rect:
        raise ValueError("multi-process training is incompatible with "
                         "--rect: aspect-sorted batch shapes diverge across "
                         "processes")


def make_run_mesh(cfg: TrainConfig, pc: int) -> Mesh:
    """The run's mesh: its ``pc`` processes as ``pc // spatial`` data rows
    of ``spatial`` (every process calls it). Spatial partitioning keeps to
    one host, as the JAX engine's multi-process runs keep to spatial 1."""
    if cfg.spatial > 1 and multihost.host_count() > 1:
        raise ValueError(
            "multi-host training supports spatial=1 only (each host's "
            "processes load whole images of their data rows)")
    return make_mesh(pc, spatial=cfg.spatial)


def check_mesh_size(cfg: TrainConfig, mesh: Mesh, imgsz: int,
                    stride: int) -> None:
    """``check_spatial`` at the smallest size the run feeds (multi-scale's
    0.5x floor in ``stride`` multiples), as the JAX engine holds it."""
    if cfg.spatial <= 1:
        return
    min_sz = ((imgsz // 2) // stride * stride) if cfg.multi_scale else imgsz
    check_spatial(mesh, min_sz, max_stride=stride)
    LOGGER.info("mesh: %d-way data x %d-way spatial", mesh.n_data,
                mesh.spatial)


def _snapshot(cfg: TrainConfig) -> Dict:
    """The run's options with real types, path-like fields absolute, so a
    bare --resume can restore them from any directory."""
    snap = {}
    for k, v in vars(cfg).items():
        if not isinstance(v, (str, int, float, bool, type(None))):
            v = str(v)
        if (k in ("data", "cfg", "hyp", "weights", "project")
                and isinstance(v, str) and os.path.exists(v)):
            v = os.path.abspath(v)
        snap[k] = v
    return snap


def make_run_dir(cfg: TrainConfig, hyp: Dict) -> str:
    """runs/train/exp{N} with ``hyp.yaml`` and ``opt.yaml``, written as
    JSON text (valid YAML), so no PyYAML is needed to write or read them."""
    from desenet_tpu_torch.utils.general import increment_path

    save_dir = str(increment_path(os.path.join(cfg.project, cfg.name),
                                  exist_ok=cfg.exist_ok, mkdir=True))
    for name, obj in (("hyp.yaml", hyp), ("opt.yaml", _snapshot(cfg))):
        with open(os.path.join(save_dir, name), "w", encoding="utf-8") as f:
            json.dump(obj, f, indent=1)
    return save_dir


@dataclass
class Loop:
    """What the epoch loop needs: the state and its step, the schedule
    (``lf``, ``lr0``, ``nb`` batches an epoch), the validator whose model is
    the eval twin, the checkpoints' meta, and where the loop starts."""
    state: TrainState
    step: Callable
    lf: Callable
    lr0: float
    nb: int
    validator: object  # eval.Validator over the eval twin, or None
    meta: Dict
    start_epoch: int = 0
    best_fitness: float = 0.0
    wandb: object = None  # utils.wandb_logger.WandbLogger, or None


def build_loop(cfg: TrainConfig, hyp: Dict, de_nc: int, se_nc: int, nb: int,
               imgsz: int, device, meta: Dict, save_dir: str = "",
               names: Optional[Dict[int, str]] = None, anchors=None,
               init: Optional[Dict[str, torch.Tensor]] = None,
               resumed: Optional[Dict] = None,
               generator: Optional[torch.Generator] = None,
               mesh: Optional[Mesh] = None) -> Loop:
    """The model in training mode on ``device`` (weights from
    ``generator``, then ``init`` transferred by name and shape, or the
    whole state from ``resumed``), its ``TrainState``, the training step
    with the warmup of ``max(round(warmup_epochs * nb), warmup_floor)``
    iterations (on ``mesh``'s bands where it has a spatial axis), and
    ``Validator`` over the eval twin (full-resolution seg logits, the
    compute dtype)."""
    from desenet_tpu_torch.eval import Validator
    from desenet_tpu_torch.utils.checkpoint import (intersect_trees,
                                                    restore_train_state)

    dev = torch.device(device)
    dtype = torch.bfloat16 if cfg.dtype == "bfloat16" else torch.float32
    mf = torch.channels_last if dev.type == "cuda" else torch.contiguous_format

    def build(seg_upsample: bool, train: bool):
        return build_model(config_path(cfg.cfg), nc=de_nc, se_nc=se_nc,
                           seg_upsample=seg_upsample, train=train,
                           anchors=anchors)

    model, spec = build(not cfg.fused_seg_loss, True)
    model.remat = cfg.remat
    init_weights(model, generator or torch.Generator().manual_seed(cfg.seed))
    if init is not None and resumed is None:
        sd, n = intersect_trees(init, model.state_dict())
        model.load_state_dict(sd)
        LOGGER.info("transferred %d tensors from %s", n, cfg.weights)
    model.to(dev, memory_format=mf)

    det_loss, opt_cfg, lf = loss_and_schedule(
        hyp, spec, imgsz, cfg.epochs, cfg.linear_lr, cfg.adam,
        cfg.label_smoothing)
    warmup_iters = max(round(hyp["warmup_epochs"] * nb), cfg.warmup_floor)
    state = create_train_state(model, opt_cfg)
    start_epoch, best_fitness = 0, 0.0
    if resumed is not None:
        restore_train_state(state, resumed)
        start_epoch = int(resumed["counters"]["epoch"]) + 1
        best_fitness = float(resumed["counters"]["best_fitness"])
    step = make_train_step(
        model, det_loss, opt_cfg, lf, nb=nb, warmup_iters=warmup_iters,
        nominal_bs=cfg.nbs, batch_size=cfg.batch_size,
        det_gain=cfg.det_gain, seg_gain=cfg.seg_gain, freeze=cfg.freeze,
        fused_seg=cfg.fused_seg_loss, dtype=dtype, mesh=mesh)
    eval_model, _ = build(True, False)
    eval_model.to(dev, dtype, memory_format=mf)
    validator = Validator(eval_model, nc=de_nc, se_nc=se_nc,
                          single_cls=cfg.single_cls, save_dir=save_dir,
                          names=names)
    return Loop(state=state, step=step, lf=lf, lr0=opt_cfg.lr0, nb=nb,
                validator=validator, meta=meta, start_epoch=start_epoch,
                best_fitness=best_fitness)


def train(cfg: TrainConfig, callbacks: Optional[Callbacks] = None) -> Dict:
    """Train as ``desenet_tpu.train.engine.train`` does; returns
    ``{"save_dir", "best_fitness", **the last validation's metrics}``."""
    from desenet_tpu_torch.data import create_mixed_dataloader, to_device
    from desenet_tpu_torch.utils import checkpoint as ckpt
    from desenet_tpu_torch.utils.general import (check_dataset,
                                                 check_img_size, init_seeds,
                                                 labels_to_class_weights,
                                                 labels_to_image_weights)
    from desenet_tpu_torch.utils.loggers import Loggers

    pc, is_main = process_count(), process_index() == 0
    dev = resolve_device(cfg.device)
    check_processes(cfg, pc)
    mesh = make_run_mesh(cfg, pc)
    callbacks = callbacks or Callbacks()
    if cfg.fast_decode:  # before the run directory: no libjpeg, no run
        from desenet_tpu_torch.data.dataset import require_fast_decode

        require_fast_decode()
    generator = init_seeds(cfg.seed)
    hyp = load_hyp(cfg.hyp)
    # process 0 makes the run directory and sends its name to the others
    save_dir = make_run_dir(cfg, hyp) if is_main else None
    save_dir = multihost.broadcast_str("save_dir", save_dir)
    if is_main:
        callbacks.auto_register(Loggers(save_dir, use_tb=cfg.use_tb))
    wb = _wandb_logger(cfg, hyp, save_dir) if is_main and cfg.wandb else None
    if wb is not None:
        callbacks.auto_register(wb)
    data_cfg, cfg = _resolve_artifacts(cfg, wb, pc)

    data = check_dataset(data_cfg)
    if wb is not None and cfg.upload_dataset:
        # the splits keep their local paths in this run; the artifacts
        # carry copies
        wb.log_dataset_artifact(
            {"train": data.get("train"), "val": data.get("val")},
            dict(enumerate(data["de"]["names"])), project=cfg.project)
    de_nc = 1 if cfg.single_cls else int(data["de"]["nc"])
    se_nc = int(data["se"]["nc"])
    de_names = ["item"] if cfg.single_cls else list(data["de"]["names"])
    _, spec = build_model(config_path(cfg.cfg), nc=de_nc, se_nc=se_nc)
    stride = max(spec.det_strides)
    imgsz = check_img_size(cfg.imgsz, s=stride)
    check_mesh_size(cfg, mesh, imgsz, stride)

    resumed = init = None
    if cfg.resume:
        resumed = ckpt.load_checkpoint(cfg.resume)
        LOGGER.info("resuming from %s (epoch %d)", cfg.resume,
                    int(resumed["counters"]["epoch"]))
    elif cfg.weights:
        init = ckpt.inference_state_dict(ckpt.load_checkpoint(cfg.weights))

    # the loader's threads copy each batch to the card ahead of the step
    # (multi-scale resizes host batches first, so it stages none); each
    # process loads a strided shard of every epoch. Process 0 writes the
    # label and image caches first, the others then read them.
    n_dp, data_rank = mesh.n_data, mesh.data_index
    local_bs = cfg.batch_size // n_dp
    if not is_main:
        multihost.sync_hosts("dataset_cache")
    train_loader, train_ds = create_mixed_dataloader(
        data["train"], img_size=imgsz, batch_size=local_bs,
        augment=True, hyp=hyp, stride=stride, single_cls=cfg.single_cls,
        workers=cfg.workers, max_targets=cfg.max_targets, seed=cfg.seed,
        stage=None if cfg.multi_scale else to_device(dev), rect=cfg.rect,
        quad=cfg.quad, fast_decode=cfg.fast_decode,
        cache_images=cfg.cache_images, rank=data_rank, world_size=n_dp)
    val_loader = None
    if is_main:  # validation runs on process 0 only
        val_loader, _ = create_mixed_dataloader(
            data["val"], img_size=imgsz, batch_size=local_bs,
            augment=False, rect=True, pad=0.5, stride=stride,
            single_cls=cfg.single_cls, workers=cfg.workers,
            max_targets=cfg.max_targets, seed=cfg.seed)
        multihost.sync_hosts("dataset_cache")
    # every process takes the same number of steps an epoch: the floor over
    # the ranks (a rank may own one more sample of the strided order)
    nb = (len(train_ds) // n_dp) // local_bs if n_dp > 1 else len(train_loader)
    class_weights = labels_to_class_weights(train_ds.det_labels, de_nc)
    LOGGER.info("class weights: %s", np.round(class_weights, 3))

    # autoanchor's BPR gate; new anchors rebuild the model (the parameter
    # shapes do not depend on them)
    anchors = None
    if not cfg.noautoanchor:
        from desenet_tpu_torch.utils.autoanchor import check_anchors

        cur = np.asarray(spec.layers[spec.det_layer].args[1],
                         np.float32).reshape(len(spec.det_strides), -1, 2)
        new, changed = check_anchors(train_ds, cur, spec.det_strides,
                                     thr=hyp["anchor_t"], imgsz=imgsz,
                                     seed=cfg.seed)
        if changed:
            anchors = new

    meta = {"cfg": cfg.cfg, "imgsz": imgsz, "de_nc": de_nc, "se_nc": se_nc,
            "de_names": de_names, "se_names": list(data["se"]["names"]),
            "hyp": hyp}
    if anchors is not None:  # autoanchor's, for the loaders of the weights
        meta["anchors"] = np.asarray(anchors, np.float64).tolist()
    loop = build_loop(cfg, hyp, de_nc, se_nc, nb, imgsz, dev, meta,
                      save_dir=save_dir, names=dict(enumerate(de_names)),
                      anchors=anchors, init=init, resumed=resumed,
                      generator=generator, mesh=mesh)
    loop.wandb = wb
    if not is_main:
        loop.validator = None

    resample = None
    if cfg.image_weights:
        def resample(rng):
            iw = labels_to_image_weights(train_ds.det_labels, de_nc,
                                         class_weights)
            train_ds.resample(iw + 1e-9, rng)

    return fit(cfg, loop, train_loader, val_loader, save_dir, callbacks,
               imgsz=imgsz, stride=stride, resample=resample)


def _wandb_logger(cfg: TrainConfig, hyp: Dict, save_dir: str):
    """The run's ``WandbLogger`` under ``save_dir``; ``bbox_interval`` -1
    becomes ``epochs // 10`` (1 up to 10 epochs)."""
    from desenet_tpu_torch.utils.wandb_logger import WandbLogger

    bbox_interval = (cfg.bbox_interval if cfg.bbox_interval > 0 else
                     (cfg.epochs // 10 if cfg.epochs > 10 else 1))
    return WandbLogger(project=os.path.basename(cfg.project)
                       or "desenet_tpu_torch", name=cfg.name,
                       config={**_snapshot(cfg), "hyp": hyp},
                       bbox_interval=bbox_interval, entity=cfg.entity,
                       dir=save_dir)


def _resolve_artifacts(cfg: TrainConfig, wb, pc: int):
    """``(data, cfg)``: the dataset yaml (a path, or the loaded dict with
    its ``wandb-artifact://`` splits at ``cfg.artifact_alias`` made local)
    and ``cfg`` with ``wandb-artifact://`` ``resume`` and ``weights`` made
    local. Process 0 resolves (with an enabled logger); the others take its
    result."""
    from desenet_tpu_torch.utils.general import load_yaml
    from desenet_tpu_torch.utils.wandb_logger import WANDB_ARTIFACT_PREFIX

    data, paths = cfg.data, {}
    if wb is not None and wb.enabled:
        if isinstance(data, (str, os.PathLike)):
            data = load_yaml(data)
        for k in ("train", "val"):
            if str(data.get(k, "")).startswith(WANDB_ARTIFACT_PREFIX):
                local = wb.download_dataset_artifact(
                    data[k], alias=cfg.artifact_alias)
                if not local:
                    raise FileNotFoundError(
                        f"dataset artifact {data[k]} not found")
                data[k] = local
        for attr in ("resume", "weights"):
            path = getattr(cfg, attr)
            if str(path).startswith(WANDB_ARTIFACT_PREFIX):
                local = wb.download_model_artifact(path)
                if not local:
                    raise FileNotFoundError(f"model artifact {path} not found")
                paths[attr] = local
    if pc > 1 and cfg.wandb:
        data, paths = json.loads(multihost.broadcast_str(
            "wandb_artifacts", json.dumps([data, paths])))
    return data, dataclasses.replace(cfg, **paths)


def _multi_scale(batch: Dict, rng: np.random.Generator, imgsz: int,
                 stride: int) -> Dict:
    """A random 0.5-1.5x size in stride multiples, aspect-preserving per
    dimension (the reference's sf = sz / max(shape), ns = ceil(dim * sf /
    gs) * gs); host batches, cv2 resize (nearest for the seg labels)."""
    sz = (int(rng.uniform(0.5, 1.5) * imgsz) // stride) * stride
    h, w = batch["image"].shape[1:3]
    sf = sz / max(h, w)
    nh = int(math.ceil(h * sf / stride) * stride)
    nw = int(math.ceil(w * sf / stride) * stride)
    if (nh, nw) == (h, w):
        return batch
    import cv2

    return {**batch,
            "image": np.stack([cv2.resize(im, (nw, nh),
                                          interpolation=cv2.INTER_LINEAR)
                               for im in batch["image"]]),
            "seg_labels": np.stack([cv2.resize(m.astype(np.uint8), (nw, nh),
                                               interpolation=cv2.INTER_NEAREST)
                                    for m in batch["seg_labels"]])}


def fit(cfg: TrainConfig, loop: Loop, train_batches: Iterable,
        val_batches: Iterable, save_dir: str,
        callbacks: Optional[Callbacks] = None, imgsz: Optional[int] = None,
        stride: int = 32, resample: Optional[Callable] = None) -> Dict:
    """The epochs ``loop.start_epoch`` to ``cfg.epochs - 1``: train on
    ``train_batches`` (``loop.nb`` of them an epoch), validate the EMA on
    ``val_batches``, log, checkpoint under ``save_dir`` (unless
    ``cfg.nosave``), stop early; then strip ``best``. ``resample(rng)``
    resamples the images at each epoch start (``image_weights``). With
    several processes, process 0 validates, logs and checkpoints, and the
    others take its fitness."""
    from desenet_tpu_torch.utils import checkpoint as ckpt
    from desenet_tpu_torch.utils.convert import load_state_dict
    from desenet_tpu_torch.utils.general import EarlyStopping
    from desenet_tpu_torch.utils.metrics import fitness_det_seg

    callbacks = callbacks or Callbacks()
    imgsz = imgsz or cfg.imgsz
    state, step, nb = loop.state, loop.step, loop.nb
    dev = next(iter(state.params.values())).device
    pc, is_main = process_count(), process_index() == 0
    stopper = EarlyStopping(patience=cfg.patience)
    best_fitness = loop.best_fitness
    callbacks.run("on_train_start")
    if is_main:
        LOGGER.info("training %s on %s for %d epochs (%d batches/epoch, "
                    "%s%s)", cfg.cfg, cfg.data, cfg.epochs, nb, dev,
                    f", {pc} processes" if pc > 1 else "")
    t_start = time.time()
    final_results = {}
    ms_rng = np.random.default_rng(cfg.seed + 7)
    for epoch in range(loop.start_epoch, cfg.epochs):
        callbacks.run("on_train_epoch_start")
        if hasattr(train_batches, "set_epoch"):
            train_batches.set_epoch(epoch)
        if resample is not None:
            resample(ms_rng)
        # per-batch loss tensors, read in one stacked copy at the log ticks
        loss_hist = []
        mloss_sum = np.zeros(4, np.float64)
        mloss_n = 0
        mloss = np.zeros(4, np.float64)  # box, obj, cls, seg running means
        t_ep = time.time()
        for i, batch in enumerate(train_batches):
            if i >= nb:
                break
            batch = {k: batch[k] for k in BATCH_KEYS}
            if cfg.multi_scale:
                batch = _multi_scale(batch, ms_rng, imgsz, stride)
            state, metrics = step(state, batch)
            loss_hist.append(torch.stack([metrics[k] for k in LOSS_KEYS]))
            if (i + 1) % max(nb // 4, 1) == 0 or i == nb - 1:
                mloss_sum += torch.stack(loss_hist).double().sum(0).cpu() \
                    .numpy()
                mloss_n += len(loss_hist)
                loss_hist.clear()
                mloss = mloss_sum / max(mloss_n, 1)
                if is_main:
                    LOGGER.info("epoch %d/%d batch %d/%d  box %.4f obj %.4f "
                                "cls %.4f seg %.4f  lr %.5f", epoch,
                                cfg.epochs - 1, i + 1, nb, *mloss,
                                metrics["lr"])
            callbacks.run("on_train_batch_end")
        callbacks.run("on_train_epoch_end")

        results = dict(mp=0.0, mr=0.0, map50=0.0, map=0.0, miou=0.0,
                       pix_acc=0.0)
        if loop.validator is not None and (not cfg.noval
                                           or epoch == cfg.epochs - 1):
            load_state_dict(loop.validator.model, state.ema)
            callbacks.run("on_val_start")
            results = loop.validator.run(val_batches)
            callbacks.run("on_val_end")
        fi = multihost.broadcast_float(fitness_det_seg(
            np.asarray([[results["mp"], results["mr"], results["map50"],
                         results["map"]]]), results["miou"])[0])
        row = {
            "epoch": epoch,
            "train/box_loss": mloss[0], "train/obj_loss": mloss[1],
            "train/cls_loss": mloss[2], "train/seg_loss": mloss[3],
            "metrics/precision": results["mp"],
            "metrics/recall": results["mr"],
            "metrics/mAP_0.5": results["map50"],
            "metrics/mAP_0.5:0.95": results["map"],
            "metrics/mIoU": results["miou"],
            "metrics/pixAcc": results["pix_acc"],
            "val/fitness": fi,
            "x/lr": float(loop.lr0 * loop.lf(np.float32(epoch))),
        }
        callbacks.run("on_fit_epoch_end", row)
        if is_main:
            mem = (f"  mem {torch.cuda.memory_allocated(dev) / 2**30:.1f}G"
                   if dev.type == "cuda" else "")
            LOGGER.info("epoch %d done in %.1fs  mAP50 %.4f mAP %.4f mIoU "
                        "%.4f fitness %.4f%s", epoch, time.time() - t_ep,
                        results["map50"], results["map"], results["miou"],
                        fi, mem)

        if fi > best_fitness:
            best_fitness = fi
        if not cfg.nosave and is_main:
            ckpt.save_checkpoint(os.path.join(save_dir, "last"), state, epoch,
                                 best_fitness, loop.meta)
            if best_fitness == fi:
                ckpt.save_checkpoint(os.path.join(save_dir, "best"), state,
                                     epoch, best_fitness, loop.meta)
            if cfg.save_period > 0 and epoch % cfg.save_period == 0:
                ckpt.save_checkpoint(os.path.join(save_dir, f"epoch{epoch}"),
                                     state, epoch, best_fitness, loop.meta)
            callbacks.run("on_model_save")
            if loop.wandb is not None and loop.wandb.enabled:
                loop.wandb.log_model(os.path.join(save_dir, "last"), epoch,
                                     fi, best_model=best_fitness == fi,
                                     total_epochs=cfg.epochs)
        # no process goes on (or ends) while process 0 writes
        multihost.sync_hosts(f"ckpt_epoch_{epoch}")
        final_results = results
        if stopper(epoch, fi):
            break

    if is_main:
        LOGGER.info("training finished in %.1f min; best fitness %.4f",
                    (time.time() - t_start) / 60, best_fitness)
    if (not cfg.nosave and is_main
            and os.path.isdir(os.path.join(save_dir, "best"))):
        # the inference checkpoint: EMA weights, no optimizer
        ckpt.strip_checkpoint(os.path.join(save_dir, "best"),
                              os.path.join(save_dir, "best_stripped"))
    callbacks.run("on_train_end")
    callbacks.run("teardown")
    multihost.sync_hosts("train_end")
    return {"save_dir": save_dir, "best_fitness": best_fitness,
            **final_results}
