"""Dataset-artifact upload CLI on the port.

    python -m desenet_tpu_torch.cli.log_dataset --data data.yaml \\
        [--project P] [--name N] [--entity E] [--single-cls]

Counterpart of ``desenet_tpu/cli/log_dataset.py``: logs the train and val
splits as W&B dataset artifacts and writes ``<data>_wandb.yaml`` beside the
data yaml, whose split paths are ``wandb-artifact://`` references, then
prints its path. Without the ``wandb`` package the run goes to the offline
backend under WANDB_DIR (else ./wandb), where ``cli.train --wandb`` finds
the artifacts. The yaml is written as JSON text, a subset of YAML that
``utils/general.load_yaml`` reads without PyYAML (and PyYAML reads too).
"""

from __future__ import annotations

import argparse
import json
from pathlib import Path

from desenet_tpu_torch.utils.general import check_dataset, set_logging
from desenet_tpu_torch.utils.wandb_logger import WandbLogger


def create_dataset_artifact(data: str, project: str = "desenet_tpu_torch",
                            name: str = "log dataset",
                            entity: str | None = None,
                            single_cls: bool = False) -> Path:
    """Log the dataset splits and write the artifact-referencing yaml.
    Returns the path of the written ``*_wandb.yaml``."""
    data_dict = check_dataset(data)
    if single_cls:  # one detection class, as train --single-cls
        data_dict = dict(data_dict)
        data_dict["de"] = {"nc": 1, "names": ["item"]}
    names = dict(enumerate(data_dict["de"]["names"]))

    wb = WandbLogger(project=Path(project).stem or project, name=name,
                     entity=entity, job_type="Dataset Creation",
                     config={"data": str(data), "single_cls": single_cls})
    out = wb.log_dataset_artifact(data_dict, names, project=project)
    wb.on_train_end()

    cfg_path = Path(str(data)).with_name(
        Path(str(data)).stem + "_wandb.yaml")
    with open(cfg_path, "w", encoding="utf-8") as f:
        json.dump(out, f, indent=1)
    print(f"Created dataset config file {cfg_path}")
    return cfg_path


def main(argv=None):
    set_logging()
    p = argparse.ArgumentParser(
        description="upload a dataset as W&B artifacts")
    p.add_argument("--data", type=str, required=True, help="data.yaml path")
    p.add_argument("--single-cls", action="store_true",
                   help="train as single-class dataset")
    p.add_argument("--project", type=str, default="desenet_tpu_torch",
                   help="name of W&B project")
    p.add_argument("--entity", default=None, help="W&B entity")
    p.add_argument("--name", type=str, default="log dataset",
                   help="name of W&B run")
    opt = p.parse_args(argv)
    return create_dataset_artifact(opt.data, project=opt.project,
                                   name=opt.name, entity=opt.entity,
                                   single_cls=opt.single_cls)


if __name__ == "__main__":
    main()
