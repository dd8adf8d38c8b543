"""Hyperparameter sweep on the port.

    python -m desenet_tpu_torch.cli.sweep --print-config     # search space
    python -m desenet_tpu_torch.cli.sweep --local N --data data.yaml ...
    wandb agent <sweep-id> -- python -m desenet_tpu_torch.cli.sweep --data ...

Counterpart of ``desenet_tpu/cli/sweep.py``: ``--print-config`` prints
``SWEEP_CONFIG``; ``--local N`` runs N trials of a random search with no
agent and no network, each hyp drawn from the search space by
``_sample_hyp`` (the JAX package's draws from the same seed), trained and
logged through ``print_mutation`` into ``<project>/evolve.csv`` and
``hyp_evolve.yaml``; otherwise (the agent mode, with WANDB_MODE=online and
the ``wandb`` package) the sampled hyp comes from ``wandb.config`` and one
run trains on it. Each trial's hyp is written to
``<project>/trial<N>_hyp.yaml`` (JSON text). ``--device`` as in
``cli.train`` (``cuda`` by default).
"""

from __future__ import annotations

import argparse
import json
import os

from desenet_tpu_torch.train.engine import DEFAULT_HYP, TrainConfig, train
from desenet_tpu_torch.utils.general import print_mutation, set_logging
from desenet_tpu_torch.utils.wandb_logger import SWEEP_CONFIG, transport


def _sample_hyp(rng):
    """One random draw from the sweep search space (a numpy Generator)."""
    hyp = dict(DEFAULT_HYP)
    for k, spec in SWEEP_CONFIG["parameters"].items():
        if k not in hyp:
            continue
        if spec.get("distribution") == "uniform":
            hyp[k] = float(rng.uniform(spec["min"], spec["max"]))
        elif "values" in spec:
            hyp[k] = spec["values"][int(rng.integers(len(spec["values"])))]
    return hyp


def _write_hyp(hyp: dict, project: str, tag: str) -> str:
    os.makedirs(project, exist_ok=True)
    path = os.path.join(project, f"{tag}_hyp.yaml")
    with open(path, "w", encoding="utf-8") as f:
        json.dump(hyp, f, indent=1)
    return path


def run_local(o):
    """Random search: ``o.local`` trials sampled from SWEEP_CONFIG with
    ``np.random.default_rng(o.seed)``, each logged through
    ``print_mutation``. Returns the best (fitness, hyp)."""
    import numpy as np

    rng = np.random.default_rng(o.seed)
    best = (-1.0, None)
    for trial in range(o.local):
        hyp = _sample_hyp(rng)
        cfg = TrainConfig(
            data=o.data, cfg=o.cfg,
            hyp=_write_hyp(hyp, o.project, f"trial{trial}"),
            epochs=o.epochs, batch_size=o.batch_size, imgsz=o.img_size,
            project=o.project, name=f"trial{trial}", exist_ok=True,
            use_tb=False, device=o.device,
            **(json.loads(o.train_kwargs) if o.train_kwargs else {}))
        results = train(cfg)
        fi = float(results.get("best_fitness", 0.0))
        print_mutation({"fitness": fi}, hyp, o.project)
        print(f"trial {trial}: fitness={fi:.4f}")
        if fi > best[0]:
            best = (fi, hyp)
    print(f"best fitness {best[0]:.4f}; best hyp in "
          f"{o.project}/hyp_evolve.yaml")
    return best


def main(argv=None):
    set_logging()
    p = argparse.ArgumentParser("desenet_tpu_torch sweep")
    p.add_argument("--print-config", action="store_true",
                   help="dump the sweep search space and exit")
    p.add_argument("--local", type=int, default=0,
                   help="run N local random-search trials (no wandb agent "
                        "needed; logs evolve.csv/hyp_evolve.yaml)")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--train-kwargs", type=str, default="",
                   help="JSON dict of extra TrainConfig fields for trials")
    p.add_argument("--data", type=str, default="")
    p.add_argument("--cfg", type=str, default="yolov5s_seg")
    p.add_argument("--epochs", type=int, default=50)
    p.add_argument("--batch-size", type=int, default=16)
    p.add_argument("--img-size", type=int, default=640)
    p.add_argument("--project", type=str, default="runs/sweep")
    p.add_argument("--device", type=str, default="cuda",
                   help="cuda (default) or cpu")
    o = p.parse_args(argv)

    if o.print_config:
        print(json.dumps(SWEEP_CONFIG, indent=1))
        return SWEEP_CONFIG
    if o.local:
        return run_local(o)

    run = transport(os.environ.get("WANDB_MODE", "offline")).init()
    hyp = dict(DEFAULT_HYP)
    hyp.update({k: v for k, v in dict(run.config).items() if k in hyp})
    cfg = TrainConfig(
        data=o.data, cfg=o.cfg, hyp=_write_hyp(hyp, o.project, run.id),
        epochs=o.epochs, batch_size=o.batch_size, imgsz=o.img_size,
        project=o.project, device=o.device)
    results = train(cfg)
    run.log({"val/fitness": results.get("best_fitness", 0.0)})
    return results


if __name__ == "__main__":
    main()
