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

The JAX package's schema migrations (``MIGRATIONS``, ``migrate_to_version``
and the three layout rewrites) are here too, on a JAX variables tree of
numpy arrays (``{"params": ..., "batch_stats": ...}`` as nested dicts), so
that ``utils/convert.py:state_dict_from_jax`` takes a tree of any schema:

- v1: the unfused Focus stem, its parameters at ``l{i}/conv/{conv,bn}``;
- v2: the fused 6x6 stem conv at ``l{i}/{conv,bn}``, C3 blocks stored in
  the training layout (separate ``cv1``/``cv2``);
- v3: the v2 tree with a ``layout`` entry in meta.json. Current.

``MIGRATIONS[v]`` turns a v tree into a v+1 tree. Each is exact (bit for
bit) and idempotent on a tree already migrated.
"""

from __future__ import annotations

import json
import os
from typing import Any, Dict, Mapping, Optional, Tuple

import numpy as np
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
            f"{path} holds no {WEIGHTS}: not a desenet_tpu_torch checkpoint. "
            "A reference .pt becomes one through python -m "
            "desenet_tpu_torch.tools.import_torch_ckpt; a desenet_tpu "
            "(orbax) one needs the JAX package: its tools/export_torch_sd.py "
            "writes the weights as an npz that this package loads "
            "(utils/convert.py:load_npz_state_dict), or "
            "utils/convert.py:train_state_from_jax takes its training "
            "state. python -m desenet_tpu_torch.tools.export_torch_sd goes "
            "the other way, from this package's checkpoint to the "
            "reference's state dict")
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


def _deep_copy(d: dict) -> dict:
    return {k: _deep_copy(v) if isinstance(v, dict) else v
            for k, v in d.items()}


def _sites(params: dict, is_site, path=()):
    """Paths of the sub-dicts of ``params`` (depth first) that
    ``is_site`` accepts."""
    for k, v in params.items():
        if isinstance(v, dict):
            if is_site(v):
                yield path + (k,)
            yield from _sites(v, is_site, path + (k,))


def _at(tree, site):
    """The sub-dict of ``tree`` at ``site``, or None where it has none."""
    for s in site:
        if not isinstance(tree, dict) or s not in tree:
            return None
        tree = tree[s]
    return tree


def migrate_focus_params(variables: dict) -> dict:
    """A tree with the unfused Focus stem (parameters under
    ``l{i}/conv/{conv,bn}``) in the fused-conv layout (``l{i}/{conv,bn}``),
    by the exact space-to-depth rearrangement of the kernel. The rows are
    found in ``params`` (a row holding only a nested ConvBnAct whose kernel
    takes a multiple of 4 input channels), then rewritten in every
    collection."""
    params = variables.get("params", {})
    migrate = set()
    for lname, sub in params.items():
        try:
            w = np.asarray(sub["conv"]["conv"]["conv2d"]["kernel"])
        except (KeyError, TypeError):
            continue
        if set(sub) == {"conv"} and w.ndim == 4 and w.shape[2] % 4 == 0:
            migrate.add(lname)
    if not migrate:
        return variables

    out = {}
    for col, tree in variables.items():
        tree = dict(tree)
        for lname in migrate:
            if lname not in tree:
                continue
            inner = tree[lname]["conv"]  # Focus's ConvBnAct: {conv, bn}
            new = {}
            if "conv" in inner:
                w4 = np.asarray(inner["conv"]["conv2d"]["kernel"])
                k, _, c4, o = w4.shape
                c = c4 // 4
                w6 = np.zeros((2 * k, 2 * k, c, o), w4.dtype)
                for oy in range(2):
                    for ox in range(2):
                        s = oy + 2 * ox
                        w6[oy::2, ox::2] = w4[:, :, c * s:c * (s + 1), :]
                new["conv"] = {"conv2d": {"kernel": w6}}
            if "bn" in inner:
                new["bn"] = inner["bn"]
            tree[lname] = new
        out[col] = tree
    return out


def _is_bottleneck(m) -> bool:
    """C3's inner block is a Bottleneck (cv1 1x1, cv2 3x3). C3Ghost and
    C3TR share C3's outer layout, but their ``m_0`` (a GhostBottleneck, a
    TransformerBlock) has no fused ``cv12`` form, so they are not
    migrated."""
    if not isinstance(m, dict):
        return False
    try:
        k1 = m["cv1"]["conv"]["conv2d"]["kernel"]
        k2 = m["cv2"]["conv"]["conv2d"]["kernel"]
    except (TypeError, KeyError):
        return False
    return (tuple(np.shape(k1)[:2]) == (1, 1)
            and tuple(np.shape(k2)[:2]) == (3, 3))


def _is_unfused_c3(v: dict) -> bool:
    """A C3 in the training layout; ``cv4`` marks a BottleneckCSP."""
    return ("cv1" in v and "cv2" in v and "cv3" in v and "m_0" in v
            and "cv4" not in v
            and isinstance(v.get("cv1"), dict) and "conv" in v["cv1"]
            and isinstance(v.get("cv2"), dict) and "conv" in v["cv2"]
            and _is_bottleneck(v["m_0"]))


def migrate_unfused_c3(variables: dict) -> dict:
    """A tree with C3 blocks in the training layout (separate ``cv1`` and
    ``cv2`` ConvBnActs) in the fused ``cv12``/``bn12`` layout: kernels
    concatenated along the output axis, BN leaves per channel. Exact."""
    sites = list(_sites(variables.get("params", {}), _is_unfused_c3))
    if not sites:
        return variables
    out = {col: _deep_copy(tree) for col, tree in variables.items()}
    for col, tree in out.items():
        for site in sites:
            sub = _at(tree, site)
            if sub is None or "cv1" not in sub or "cv2" not in sub:
                continue
            cv1 = sub.pop("cv1")
            cv2 = sub.pop("cv2")
            if col == "params" and "conv" in cv1:
                sub["cv12"] = {"conv2d": {"kernel": np.concatenate(
                    [np.asarray(cv1["conv"]["conv2d"]["kernel"]),
                     np.asarray(cv2["conv"]["conv2d"]["kernel"])], axis=-1)}}
            if "bn" in cv1:
                sub["bn12"] = {"bn": {
                    kk: np.concatenate([np.asarray(cv1["bn"]["bn"][kk]),
                                        np.asarray(cv2["bn"]["bn"][kk])],
                                       axis=0)
                    for kk in cv1["bn"]["bn"]}}
    return out


def defuse_c3(variables: dict) -> dict:
    """The inverse of ``migrate_unfused_c3``: fused ``cv12``/``bn12`` C3
    blocks split back into ``cv1``/``cv2`` ConvBnActs (the training
    layout)."""
    sites = list(_sites(variables.get("params", {}),
                        lambda v: "cv12" in v and "bn12" in v))
    if not sites:
        return variables
    out = {col: _deep_copy(tree) for col, tree in variables.items()}
    for col, tree in out.items():
        for site in sites:
            sub = _at(tree, site)
            if sub is None:
                continue
            if col == "params" and "cv12" in sub:
                w = np.asarray(sub.pop("cv12")["conv2d"]["kernel"])
                half = w.shape[-1] // 2
                sub.setdefault("cv1", {})["conv"] = {
                    "conv2d": {"kernel": w[..., :half]}}
                sub.setdefault("cv2", {})["conv"] = {
                    "conv2d": {"kernel": w[..., half:]}}
            if "bn12" in sub:
                bn = sub.pop("bn12")["bn"]
                h = {k: np.asarray(v).shape[0] // 2 for k, v in bn.items()}
                sub.setdefault("cv1", {})["bn"] = {
                    "bn": {k: np.asarray(v)[:h[k]] for k, v in bn.items()}}
                sub.setdefault("cv2", {})["bn"] = {
                    "bn": {k: np.asarray(v)[h[k]:] for k, v in bn.items()}}
    return out


def migrate_legacy(variables: dict) -> dict:
    """Every layout migration, for an unversioned tree: the fused Focus
    stem, then the fused C3."""
    return migrate_unfused_c3(migrate_focus_params(variables))


# version v -> the function that makes a v+1 tree of it; v2 -> v3 added
# only meta.json's "layout", the tree is unchanged
MIGRATIONS = {
    1: migrate_focus_params,
    2: lambda variables: variables,
}


def migrate_to_version(variables: dict, from_version: int,
                       to_version: int = SCHEMA_VERSION) -> dict:
    """A tree of schema ``from_version`` through ``MIGRATIONS`` up to
    ``to_version``. ValueError for a schema newer than this code's or one
    with no registered migration."""
    v = int(from_version)
    if v > SCHEMA_VERSION:
        raise ValueError(
            f"checkpoint schema v{v} is newer than this code "
            f"(v{SCHEMA_VERSION}); upgrade desenet_tpu_torch to load it")
    while v < to_version:
        if v not in MIGRATIONS:
            raise ValueError(f"no migration registered for schema v{v}")
        variables = MIGRATIONS[v](variables)
        v += 1
    return variables
