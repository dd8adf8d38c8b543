"""Weights & Biases sink: dataset artifacts, model artifacts with aliases,
artifact-path resume (``wandb-artifact://``), the per-image validation
media panel (boxes and segmentation masks) and the evaluation result
Table.

The port's counterpart of ``desenet_tpu/utils/wandb_logger.py``, with the
same surface and the same run files. Transport (``transport``), by the
mode (``mode=`` or WANDB_MODE, ``offline`` by default): ``offline`` writes
through the port's offline backend (``utils/wandb_offline.py``, the same
API; the real package's offline mode cannot resolve artifacts without a
server), whether or not the ``wandb`` package is installed; ``online``
takes the real package (ImportError where it is not installed; a run it
cannot start, such as one without an API key, leaves the logger disabled
with a warning, as in the JAX package); ``disabled`` makes a no-op
logger. ``val_one_image`` takes a ``Detections`` row block ((n, 6) [xyxy,
conf, cls], numpy or a tensor) and a uint8 class-id mask.
"""

from __future__ import annotations

import logging
import os
from pathlib import Path
from typing import Dict, List, Optional

import numpy as np

LOGGER = logging.getLogger("desenet_tpu_torch")

WANDB_ARTIFACT_PREFIX = "wandb-artifact://"



def transport(mode: str):
    """The wandb API module for ``mode``: the real package for ``online``,
    the port's offline backend otherwise."""
    if mode != "online":
        from desenet_tpu_torch.utils import wandb_offline

        return wandb_offline
    import wandb

    # a stray ./wandb directory (offline runs) imports as a namespace
    # package; only the real package has init
    if not hasattr(wandb, "init"):
        raise ImportError("WANDB_MODE=online needs the wandb package; "
                          "'wandb' here is a directory of offline runs")
    return wandb


def _np(x) -> np.ndarray:
    """A tensor (on any device) or an array-like as numpy."""
    if hasattr(x, "detach"):
        return x.detach().cpu().numpy()
    return np.asarray(x)


def _add_split(art, images: Path) -> None:
    """A split's images under ``data/<parent>/<split>/`` of ``art`` and,
    where they exist, its label directories (``DeLabels/<split>``,
    ``SeLabels/<split>`` beside the images' parent, where
    ``data/dataset.img2label_paths`` looks) under ``data/``: the dataset
    finds the images under ``data`` by a recursive search and each one's
    labels beside it. (The JAX package's artifact holds the images alone,
    so a split resolved from it has no labels.)"""
    art.add_dir(str(images), name=f"data/{images.parent.name}/{images.name}")
    for labels in ("DeLabels", "SeLabels"):
        d = images.parent.with_name(labels) / images.name
        if d.is_dir():
            art.add_dir(str(d), name=f"data/{labels}/{images.name}")


class WandbLogger:
    """Run lifecycle and the artifact and Table logic."""

    def __init__(self, project: str = "desenet_tpu_torch",
                 name: Optional[str] = None,
                 config: Optional[Dict] = None,
                 resume_id: Optional[str] = None,
                 job_type: str = "Training",
                 mode: Optional[str] = None,
                 max_imgs_to_log: int = 16,
                 bbox_interval: int = 1,
                 entity: Optional[str] = None,
                 dir: Optional[str] = None):
        self.run = None
        self.current_epoch = 0
        self.log_dict: Dict = {}
        self.bbox_media_panel_images: List = []
        self.max_imgs_to_log = max_imgs_to_log
        self.bbox_interval = max(bbox_interval, 1)
        self.result_table = None
        self.result_artifact = None
        mode = mode or os.environ.get("WANDB_MODE", "offline")
        if mode == "disabled":
            LOGGER.info("wandb disabled — WandbLogger is a no-op")
            return
        self._wb = transport(mode)
        try:
            self.run = self._wb.init(
                project=project, name=name, config=config or {},
                id=resume_id, resume="allow" if resume_id else None,
                job_type=job_type, dir=dir, entity=entity,
            )
            self._new_result_table()
        except Exception as e:  # noqa: BLE001 - no-auth online environments
            LOGGER.warning("wandb init failed (%s) — disabled", e)
            self.run = None

    @property
    def enabled(self) -> bool:
        return self.run is not None

    def _new_result_table(self):
        self.result_table = self._wb.Table(
            ["epoch", "id", "prediction count", "avg_confidence"])
        self.result_artifact = self._wb.Artifact(
            f"run_{self.run.id}_progress", type="evaluation")

    # ------------------------------------------------------------------
    # metrics: accumulated, committed once an epoch
    def log(self, metrics: Dict, step: Optional[int] = None):
        if self.run is None:
            return
        if step is not None:
            self.run.log(metrics, step=step)
        else:
            self.log_dict.update(metrics)

    def end_epoch(self, best_result: bool = False):
        if self.run is None:
            return
        if self.bbox_media_panel_images:
            self.log_dict["BoundingBoxDebugger"] = self.bbox_media_panel_images
        if self.log_dict:
            self.run.log(self.log_dict)
        self.log_dict = {}
        self.bbox_media_panel_images = []
        if self.result_table is not None and self.result_table.data:
            self.result_artifact.add(self.result_table, "result")
            self.run.log_artifact(
                self.result_artifact,
                aliases=["latest", "last", f"epoch {self.current_epoch}",
                         "best" if best_result else ""])
            self.run.log({"evaluation": self.result_table})
            self._new_result_table()
        self.current_epoch += 1

    # ------------------------------------------------------------------
    # validation media panel
    def val_one_image(self, pred, seg_pred, path, de_names, se_names, im):
        """pred: (n, 6) [xyxy, conf, cls]; seg_pred: (H, W) class ids;
        im: HWC uint8 image (numpy or tensors)."""
        if self.run is None:
            return
        pred, seg_pred, im = _np(pred), _np(seg_pred), _np(im)
        if self.result_table is not None:
            pred = np.asarray(pred, np.float64).reshape(-1, 6)
            avg = float(pred[:, 4].mean()) if len(pred) else 0.0
            self.result_table.add_data(
                self.current_epoch, os.path.basename(str(path)), len(pred),
                round(avg, 5))
        if (len(self.bbox_media_panel_images) < self.max_imgs_to_log
                and self.current_epoch % self.bbox_interval == 0):
            box_data = [{
                "position": {"minX": float(x1), "minY": float(y1),
                             "maxX": float(x2), "maxY": float(y2)},
                "class_id": int(cls),
                "box_caption": "%s %.3f" % (de_names.get(int(cls), int(cls)),
                                            conf),
                "scores": {"class_score": float(conf)},
                "domain": "pixel",
            } for x1, y1, x2, y2, conf, cls in
                np.asarray(pred, np.float64).reshape(-1, 6).tolist()]
            boxes = {"predictions": {"box_data": box_data,
                                     "class_labels": de_names}}
            masks = {"predictions": {
                "mask_data": np.asarray(seg_pred, np.uint8),
                "class_labels": se_names}}
            self.bbox_media_panel_images.append(
                self._wb.Image(im, boxes=boxes, masks=masks,
                             caption=os.path.basename(str(path))))

    # ------------------------------------------------------------------
    # model artifacts
    def log_model(self, ckpt_dir: str, epoch: int, fitness_score: float,
                  best_model: bool = False, total_epochs: int = 0):
        if self.run is None:
            return
        art = self._wb.Artifact(
            f"run_{self.run.id}_model", type="model", metadata={
                "original_url": str(ckpt_dir),
                "epochs_trained": epoch + 1,
                "total_epochs": total_epochs,
                "fitness_score": float(fitness_score),
            })
        art.add_dir(str(ckpt_dir))
        self.run.log_artifact(
            art, aliases=["latest", "last", f"epoch {epoch}",
                          "best" if best_model else ""])
        LOGGER.info("saved model artifact at epoch %d", epoch)

    def download_model_artifact(self, artifact_path: str) -> Optional[str]:
        """Resolve a wandb-artifact:// checkpoint reference to a local dir.
        Returns None when not found."""
        if self.run is None or not str(artifact_path).startswith(
                WANDB_ARTIFACT_PREFIX):
            return None
        name = str(artifact_path)[len(WANDB_ARTIFACT_PREFIX):]
        art = self.run.use_artifact(name if ":" in name else name + ":latest")
        if art is None:
            return None
        return art.download()

    # ------------------------------------------------------------------
    # dataset artifacts
    def log_dataset_artifact(self, data_dict: Dict, names: Dict[int, str],
                             project: str = "desenet_tpu_torch"):
        """Upload train/val dirs as artifacts (``_add_split``: the images
        and their label files) and return a data dict whose splits point at
        wandb-artifact:// references."""
        if self.run is None:
            return data_dict
        out = dict(data_dict)
        for split in ("train", "val"):
            path = data_dict.get(split)
            if not path:
                continue
            art = self._wb.Artifact(f"{split}_dataset", type="dataset",
                                  metadata={"names": names})
            _add_split(art, Path(path))
            table = self._wb.Table(["id", "image"])
            imgs = sorted(
                f for f in os.listdir(path)
                if f.lower().endswith((".jpg", ".png", ".jpeg", ".bmp"))
            )[:self.max_imgs_to_log]
            for f in imgs:
                table.add_data(f, self._wb.Image(os.path.join(str(path), f)))
            art.add(table, split)
            self.run.log_artifact(art, aliases=["latest"])
            out[split] = WANDB_ARTIFACT_PREFIX + f"{split}_dataset:latest"
        return out

    def download_dataset_artifact(self, path: str,
                                  alias: str = "latest") -> Optional[str]:
        """Resolve a wandb-artifact:// dataset split to a local dir; ``alias``
        selects the artifact version (``--artifact-alias``)."""
        if self.run is None or not str(path).startswith(
                WANDB_ARTIFACT_PREFIX):
            return None
        name = str(path)[len(WANDB_ARTIFACT_PREFIX):]
        art = self.run.use_artifact(
            name if ":" in name else f"{name}:{alias}")
        if art is None:
            return None
        return os.path.join(art.download(), "data")

    # ------------------------------------------------------------------
    # simple helpers
    def log_image(self, key: str, image, boxes=None, masks=None,
                  class_labels=None):
        if self.run is None:
            return
        kwargs = {}
        if boxes is not None:
            kwargs["boxes"] = {"predictions": {
                "box_data": boxes, "class_labels": class_labels or {}}}
        if masks is not None:
            kwargs["masks"] = {"predictions": {
                "mask_data": masks, "class_labels": class_labels or {}}}
        self.run.log({key: self._wb.Image(image, **kwargs)})

    def log_artifact(self, path: str, type_: str = "model",
                     name: str = "run_model", aliases=()):
        if self.run is None:
            return
        art = self._wb.Artifact(name, type=type_)
        art.add_dir(path)
        self.run.log_artifact(art, aliases=list(aliases))

    # callback-hook methods (picked up by Callbacks.auto_register)
    def on_fit_epoch_end(self, row: Dict):
        self.log({k: v for k, v in row.items() if v != ""})
        self.end_epoch()

    def on_train_end(self, *a, **k):
        if self.run is not None:
            self.run.finish()
            self.run = None


SWEEP_CONFIG = {
    # random-search sweep over the hyp space
    "method": "random",
    "metric": {"name": "val/fitness", "goal": "maximize"},
    "parameters": {
        "lr0": {"distribution": "uniform", "min": 1e-5, "max": 0.1},
        "lrf": {"distribution": "uniform", "min": 0.01, "max": 1.0},
        "momentum": {"distribution": "uniform", "min": 0.6, "max": 0.98},
        "weight_decay": {"distribution": "uniform", "min": 0.0, "max": 0.001},
        "warmup_epochs": {"distribution": "uniform", "min": 0.0, "max": 5.0},
        "box": {"distribution": "uniform", "min": 0.02, "max": 0.2},
        "cls": {"distribution": "uniform", "min": 0.2, "max": 4.0},
        "obj": {"distribution": "uniform", "min": 0.2, "max": 4.0},
        "anchor_t": {"distribution": "uniform", "min": 2.0, "max": 8.0},
        "fl_gamma": {"distribution": "uniform", "min": 0.0, "max": 2.0},
        "hsv_h": {"distribution": "uniform", "min": 0.0, "max": 0.1},
        "hsv_s": {"distribution": "uniform", "min": 0.0, "max": 0.9},
        "hsv_v": {"distribution": "uniform", "min": 0.0, "max": 0.9},
        "translate": {"distribution": "uniform", "min": 0.0, "max": 0.9},
        "scale": {"distribution": "uniform", "min": 0.0, "max": 0.9},
        "mosaic": {"distribution": "uniform", "min": 0.0, "max": 1.0},
        "mixup": {"distribution": "uniform", "min": 0.0, "max": 1.0},
    },
}
