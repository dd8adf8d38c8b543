"""Training checkpoints of the port: save, load, strip, restore, transfer.

The counterpart of ``desenet_tpu/utils/checkpoint.py`` in the port's own
format. A checkpoint is a directory holding

- ``meta.json``: the JAX package's schema (``cfg``, ``imgsz``, ``de_nc``,
  ``se_nc``, ``de_names``, ``se_names``, ``hyp``, ``schema_version``,
  ``layout``) with ``"format": "torch"``; ``layout.focus`` is ``"focus"``
  (the port's slice-concat stem) and ``layout.c3`` ``"unfused"``;
- ``state.pt``: one ``torch.save`` of torch-named state dicts on the CPU:
  ``params`` (the trainable parameters), ``batch_stats`` (BN running means
  and variances), ``ema``, ``opt_state`` (``mu``, and for Adam ``nu`` and
  ``count``), ``accum_grads`` (the gradients accumulated in ``.grad``
  between optimizer steps) and ``counters`` (``ema_updates``, ``step``,
  ``last_opt_step``, ``epoch``, ``best_fitness``).

A stripped checkpoint (``strip_checkpoint``) holds only ``params`` and
``batch_stats``, taken from the EMA. A JAX (orbax) checkpoint is not read
here: the JAX package loads it and ``utils/convert.py:train_state_from_jax``
turns it into the port's state, which ``save_checkpoint`` then writes.
"""

from __future__ import annotations

import json
import os
from typing import Any, Dict, Mapping, Optional, Tuple

import torch

from desenet_tpu_torch.train.state import TrainState, bn_stats

SCHEMA_VERSION = 3
WEIGHTS = "state.pt"
META = "meta.json"
LAYOUT = {"focus": "focus", "c3": "unfused"}
_STATS = ("running_mean", "running_var")


def _cpu(tensors: Mapping[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    return {k: v.detach().to("cpu", copy=True) for k, v in tensors.items()}


def _state_payload(state: TrainState, epoch: int,
                   best_fitness: float) -> dict:
    """The training state as CPU tensors and host numbers."""
    opt = {"mu": _cpu(state.opt_state["mu"])}
    if "nu" in state.opt_state:
        opt["nu"] = _cpu(state.opt_state["nu"])
        opt["count"] = int(state.opt_state["count"])
    return {
        "params": _cpu(state.params),
        "batch_stats": _cpu(bn_stats(state.model)),
        "ema": _cpu(state.ema),
        "opt_state": opt,
        "accum_grads": _cpu({k: p.grad for k, p in state.params.items()
                             if p.grad is not None}),
        "counters": {
            "ema_updates": int(state.ema_updates),
            "step": int(state.step),
            "last_opt_step": int(state.last_opt_step),
            "epoch": int(epoch),
            "best_fitness": float(best_fitness),
        },
    }


def _write(path: str, payload: dict, meta: Optional[Dict[str, Any]]) -> None:
    """``payload`` to ``path/state.pt`` (through a temporary file, so a
    reader never sees half of it) and ``meta`` to ``path/meta.json``."""
    os.makedirs(path, exist_ok=True)
    tmp = os.path.join(path, WEIGHTS + ".tmp")
    torch.save(payload, tmp)
    os.replace(tmp, os.path.join(path, WEIGHTS))
    if meta is not None:
        meta = dict(meta)
        meta.setdefault("schema_version", SCHEMA_VERSION)
        meta.setdefault("layout", dict(LAYOUT))
        meta["format"] = "torch"
        with open(os.path.join(path, META), "w", encoding="utf-8") as f:
            json.dump(meta, f, indent=1)


def save_checkpoint(path: str, state: TrainState, epoch: int,
                    best_fitness: float,
                    meta: Optional[Dict[str, Any]] = None) -> None:
    """Write a full training checkpoint to the directory ``path``."""
    _write(os.path.abspath(path),
           _state_payload(state, epoch, best_fitness), meta)


def load_checkpoint(path: str) -> Dict[str, Any]:
    """A checkpoint directory's payload (CPU tensors) with its ``meta``
    (None where the directory has no meta.json)."""
    path = os.path.abspath(path)
    weights = os.path.join(path, WEIGHTS)
    if not os.path.isfile(weights):
        raise FileNotFoundError(
            f"{path} holds no {WEIGHTS}: not a desenet_tpu_torch checkpoint "
            "(a desenet_tpu one crosses through "
            "utils/convert.py:train_state_from_jax or "
            "tools/export_torch_sd.py)")
    payload = torch.load(weights, map_location="cpu", weights_only=True)
    meta_path = os.path.join(path, META)
    payload["meta"] = None
    if os.path.exists(meta_path):
        with open(meta_path, encoding="utf-8") as f:
            payload["meta"] = json.load(f)
    return payload


def split_stats(tensors: Mapping[str, torch.Tensor]
                ) -> Tuple[Dict[str, torch.Tensor], Dict[str, torch.Tensor]]:
    """(parameters, BN running statistics) of one state dict."""
    params = {k: v for k, v in tensors.items() if not k.endswith(_STATS)}
    stats = {k: v for k, v in tensors.items() if k.endswith(_STATS)}
    return params, stats


def strip_checkpoint(path: str, out_path: str) -> None:
    """Finalize for inference: the EMA becomes the weights; the optimizer,
    the accumulated gradients and the counters go."""
    payload = load_checkpoint(path)
    if payload.get("ema"):
        params, stats = split_stats(payload["ema"])
    else:
        params, stats = payload["params"], payload["batch_stats"]
    _write(os.path.abspath(out_path),
           {"params": params, "batch_stats": stats}, payload["meta"])


def inference_state_dict(payload: Mapping) -> Dict[str, torch.Tensor]:
    """The weights a model for inference loads: the EMA where the
    checkpoint has one, else its parameters and BN statistics."""
    if payload.get("ema"):
        return dict(payload["ema"])
    return {**payload["params"], **payload.get("batch_stats", {})}


def load_inference_variables(path: str
                             ) -> Tuple[Dict[str, torch.Tensor],
                                        Optional[Dict[str, Any]]]:
    """(state dict, meta) of the checkpoint directory ``path`` for
    inference: its EMA where it has one (``inference_state_dict``), and its
    meta.json (None where it has none). A JAX (orbax) checkpoint raises, as
    ``load_checkpoint`` does."""
    payload = load_checkpoint(path)
    return inference_state_dict(payload), payload["meta"]


@torch.no_grad()
def restore_train_state(state: TrainState, payload: Mapping) -> TrainState:
    """Fill ``state`` (made by ``create_train_state`` for the checkpoint's
    model) from a full checkpoint's payload, on the state's device."""

    def fill(dst: Mapping[str, torch.Tensor], src: Mapping[str, torch.Tensor],
             what: str):
        if set(dst) != set(src):
            raise KeyError(f"checkpoint {what} keys differ from the model's: "
                           f"{sorted(set(dst) ^ set(src))[:5]}")
        for k, v in src.items():
            dst[k].copy_(v)

    fill(state.params, payload["params"], "params")
    fill(bn_stats(state.model), payload["batch_stats"], "batch_stats")
    fill(state.ema, payload["ema"], "ema")
    opt = payload["opt_state"]
    fill(state.opt_state["mu"], opt["mu"], "opt_state.mu")
    if "nu" in state.opt_state:
        fill(state.opt_state["nu"], opt["nu"], "opt_state.nu")
        state.opt_state["count"] = int(opt["count"])
    for k, p in state.params.items():
        g = payload["accum_grads"].get(k)
        # in the parameter's own layout (the gradient layout contract)
        p.grad = None if g is None else torch.empty_like(p).copy_(g)
    c = payload["counters"]
    state.ema_updates = int(c["ema_updates"])
    state.step = int(c["step"])
    state.last_opt_step = int(c["last_opt_step"])
    return state


def intersect_trees(src: Mapping[str, torch.Tensor],
                    dst: Mapping[str, torch.Tensor]
                    ) -> Tuple[Dict[str, torch.Tensor], int]:
    """Transfer-learning weight intersection by name and shape: take the
    ``src`` tensors whose key exists in ``dst`` with the same shape (in
    ``dst``'s dtype), else keep ``dst``'s. Returns (tensors, number
    taken)."""
    out, n = {}, 0
    for k, v in dst.items():
        sv = src.get(k)
        if sv is not None and tuple(sv.shape) == tuple(v.shape):
            out[k] = sv.to(v.dtype)
            n += 1
        else:
            out[k] = v
    return out, n
