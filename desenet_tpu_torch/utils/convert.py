"""Weights and training state from the JAX package into the port.

A flax-free port of ``desenet_tpu/utils/torch_convert.py``
(``flax_path_to_torch_key`` with the SegMaskPSP2 name table,
``fused_csp_sources``, ``_conv_kernel_to_focus``) and of the layout
transposes of ``tools/export_torch_sd.py``. The JAX package's TPU layouts
are undone on the way: the fused 6x6 stem conv becomes the Focus 3x3 conv
over the slice-concat, and the fused C3 ``cv12``/``bn12`` split back into
``cv1``/``cv2``.
"""

from __future__ import annotations

import functools
import re
from typing import Dict, List, Mapping, Tuple

import numpy as np
import torch

from desenet_tpu_torch.models.build import DeSeNet, ModelSpec
from desenet_tpu_torch.train.optim import OptimConfig
from desenet_tpu_torch.train.state import TrainState, create_train_state

# flax sub-path prefix -> torch sub-path prefix inside the SegMaskPSP2 row
_PSP2_TABLE = {
    "stem/m8/": "m8.0/",
    "stem/m16/": "m16.0/",
    "stem/m32/": "m32.0/",
    "spatial_path/branch0_a/": "spatial_path.branch0.0/",
    "spatial_path/branch0_b/": "spatial_path.branch0.1/",
    "spatial_path/branch1/conv/conv2d/": "spatial_path.branch1.0/",
    "spatial_path/branch1/bn/bn/": "spatial_path.branch1.1/",
    "spatial_path/branch2/conv/conv2d/": "spatial_path.branch2.0/",
    "spatial_path/branch2/bn/bn/": "spatial_path.branch2.1/",
    "spatial_path/branch_global/conv/": "spatial_path.branch_global.1/",
    "spatial_path/conv_linear/": "spatial_path.ConvLinear/",
    "context_red/": "context_path.0/",
    "context_pp/": "context_path.1/",
    "out/conv2d/": "out.0/",
    "ffm/convblk/": "ffm.convblk/",
    "ffm/att_fc1/conv2d/": "ffm.channel_attention.1/",
    "ffm/att_fc2/conv2d/": "ffm.channel_attention.3/",
}

_LEAF = {
    "kernel": "weight",
    "scale": "weight",
    "bias": "bias",
    "mean": "running_mean",
    "var": "running_var",
}


def _is_fused_focus(path: Tuple[str, ...], spec: ModelSpec) -> bool:
    """A Focus row whose JAX variables are the fused 6x6 conv (one
    ConvBnAct at ``l{i}/conv`` + ``l{i}/bn``) rather than Focus's inner
    ConvBnAct (``l{i}/conv/conv`` + ``l{i}/conv/bn``)."""
    m = re.match(r"^l(\d+)$", path[0])
    return (m is not None and spec.layers[int(m.group(1))].name == "Focus"
            and path[1:3] not in (("conv", "conv"), ("conv", "bn")))


def flax_path_to_torch_key(path: Tuple[str, ...], spec: ModelSpec) -> str:
    """Translate one flattened flax variable path (collection stripped) to
    its torch state-dict key."""
    joined = "/".join(path)
    m = re.match(r"^l(\d+)(?:s(\d+))?/(.*)$", joined)
    if not m:
        raise KeyError(f"unexpected flax path {joined}")
    li = int(m.group(1))
    seq = m.group(2)
    inner = m.group(3)
    ls = spec.layers[li]

    if ls.name == "SegMaskPSP2":
        for fp, tp in _PSP2_TABLE.items():
            if inner.startswith(fp):
                inner = tp + inner[len(fp):]
                break
    elif ls.name == "Detect":
        inner = re.sub(r"^m(\d+)/", r"m.\1/", inner)
    elif _is_fused_focus(path, spec):
        inner = "conv/" + inner

    leaf_src = inner.rsplit("/", 1)[-1]
    body = inner[: -(len(leaf_src) + 1)] if "/" in inner else ""
    body = body.replace("conv/conv2d", "conv")
    body = body.replace("bn/bn", "bn")
    body = re.sub(r"(^|/)conv2d($|/)", r"\1\2", body).strip("/")
    body = re.sub(r"m_(\d+)", r"m.\1", body)
    body = body.replace("/", ".")

    prefix = f"model.{li}." + (f"{seq}." if seq else "")
    leaf = _LEAF[leaf_src]
    return prefix + (f"{body}.{leaf}" if body else leaf)


def fused_csp_sources(path: Tuple[str, ...]):
    """For a fused-C3 leaf (cv12 / bn12), the two unfused flax paths it
    merges plus the flax-side concat axis; None for any other leaf."""
    p = list(path)
    if "cv12" in p:
        i = p.index("cv12")  # (..., cv12, conv2d, kernel)
        return (tuple(p[:i] + ["cv1", "conv"] + p[i + 1:]),
                tuple(p[:i] + ["cv2", "conv"] + p[i + 1:]), -1)
    if "bn12" in p:
        i = p.index("bn12")  # (..., bn12, bn, leaf)
        return (tuple(p[:i] + ["cv1", "bn"] + p[i + 1:]),
                tuple(p[:i] + ["cv2", "bn"] + p[i + 1:]), 0)
    return None


def _conv_kernel_to_focus(w6: np.ndarray) -> np.ndarray:
    """(2k, 2k, C, O) HWIO fused stem kernel -> (O, 4C, k, k) Focus conv."""
    kk, _, c, o = w6.shape
    k = kk // 2
    out = np.zeros((o, 4 * c, k, k), w6.dtype)
    for oy in range(2):
        for ox in range(2):
            s = oy + 2 * ox
            out[:, c * s:c * (s + 1)] = np.transpose(
                w6[oy::2, ox::2], (3, 2, 0, 1))
    return out


def to_torch_tensor(x: np.ndarray, leaf: str) -> np.ndarray:
    """flax layout -> torch layout: HWIO -> OIHW, (in,out) -> (out,in)."""
    if x.ndim == 4:
        return np.transpose(x, (3, 2, 0, 1))
    if x.ndim == 2 and leaf == "kernel":
        return np.transpose(x, (1, 0))
    return x


def tree_from_jax(flat: Mapping[str, np.ndarray], spec: ModelSpec
                  ) -> Dict[str, torch.Tensor]:
    """One flattened JAX tree shaped like ``params`` or ``batch_stats``
    (``"l4/m_0/cv1/conv/conv2d/kernel"``-style paths, no collection) ->
    tensors under the port's state-dict keys (f64 stays f64, the rest
    becomes f32).

    The same map serves every tree of that shape: variables, gradients,
    momentum buffers, EMA copies. Fused C3 leaves split into ``cv1``/``cv2``
    and the fused stem kernel becomes the Focus conv's, each element to one
    element, so a gradient or buffer crosses as its parameter does."""
    out: Dict[str, np.ndarray] = {}
    for key, val in flat.items():
        path = tuple(key.split("/"))
        val = np.asarray(val)
        val = val if val.dtype == np.float64 else val.astype(np.float32)
        fs = fused_csp_sources(path)
        if fs is not None:  # split fused C3 cv12/bn12 back into cv1+cv2
            p1, p2, ax = fs
            v1, v2 = np.split(val, [val.shape[ax] // 2], axis=ax)
            out[flax_path_to_torch_key(p1, spec)] = to_torch_tensor(v1, path[-1])
            out[flax_path_to_torch_key(p2, spec)] = to_torch_tensor(v2, path[-1])
        elif _is_fused_focus(path, spec) and path[-1] == "kernel":
            out[flax_path_to_torch_key(path, spec)] = _conv_kernel_to_focus(val)
        else:
            out[flax_path_to_torch_key(path, spec)] = to_torch_tensor(
                val, path[-1])
    expected = _expected_shapes(spec)
    for k, v in out.items():
        if k not in expected:
            raise KeyError(f"JAX variable maps to {k!r}, which the port "
                           "model does not have")
        if tuple(v.shape) != expected[k]:
            raise ValueError(f"shape mismatch for {k}: {tuple(v.shape)} vs "
                             f"{expected[k]}")
    return {k: torch.tensor(v) for k, v in out.items()}


@functools.lru_cache(maxsize=8)
def _expected_shapes(spec: ModelSpec) -> Dict[str, Tuple[int, ...]]:
    """The port model's state-dict keys and shapes (built on no device)."""
    with torch.device("meta"):
        return {k: tuple(v.shape) for k, v in DeSeNet(spec).state_dict().items()}


def state_dict_from_jax(flat: Mapping[str, np.ndarray], spec: ModelSpec
                        ) -> Tuple[Dict[str, torch.Tensor], List[str]]:
    """JAX variables -> the port's state dict.

    ``flat`` maps ``"params/l4/m_0/cv1/conv/conv2d/kernel"``-style paths
    (``flax.traverse_util.flatten_dict(variables, sep="/")``, done by the
    caller) to arrays; fused and unfused JAX layouts are both accepted.
    Returns ``(state_dict, unfilled)``: ``unfilled`` lists the port model's
    keys that the JAX variables do not cover, which for a valid checkpoint
    are exactly ``DeSeNet.quirk_bn_keys()`` (BNs that never run keep their
    init)."""
    sd = {}
    for col in ("params", "batch_stats"):
        sd.update(tree_from_jax({k[len(col) + 1:]: v for k, v in flat.items()
                                 if k.startswith(col + "/")}, spec))
    for k in list(sd):
        if k.endswith(".running_var"):
            sd[k[:-len("running_var")] + "num_batches_tracked"] = \
                torch.tensor(0, dtype=torch.long)
    return sd, sorted(k for k in _expected_shapes(spec) if k not in sd)


def train_state_from_jax(jstate: Mapping, model: DeSeNet,
                         opt_cfg: OptimConfig) -> TrainState:
    """A JAX ``TrainState`` as numpy -> the port's, on ``model``'s device.

    ``jstate`` holds the JAX state's trees flattened with ``sep="/"``
    (``params``, ``batch_stats``, ``mu`` and for Adam ``nu``,
    ``ema_params``, ``ema_batch_stats``, optionally ``accum_grads``) and
    its counters as integers (``step``, ``last_opt_step``, ``ema_updates``,
    for Adam ``count``). The weights load into ``model``; the buffers, the
    EMA and the accumulated gradients (as ``.grad``) are filled in the
    state made by ``create_train_state``."""
    spec = model.spec
    load_state_dict(model, {**tree_from_jax(jstate["params"], spec),
                            **tree_from_jax(jstate["batch_stats"], spec)})
    state = create_train_state(model, opt_cfg)

    def fill(dst: Dict[str, torch.Tensor], *flats):
        src = {}
        for flat in flats:
            src.update(tree_from_jax(flat, spec))
        if set(src) != set(dst):
            raise KeyError(f"JAX tree keys differ from the port's: "
                           f"{sorted(set(src) ^ set(dst))[:5]}")
        for k, v in src.items():
            dst[k].copy_(v)

    with torch.no_grad():
        fill(state.opt_state["mu"], jstate["mu"])
        if opt_cfg.optimizer == "adam":
            fill(state.opt_state["nu"], jstate["nu"])
            state.opt_state["count"] = int(jstate["count"])
        fill(state.ema, jstate["ema_params"], jstate["ema_batch_stats"])
        if jstate.get("accum_grads") is not None:
            for k, v in tree_from_jax(jstate["accum_grads"], spec).items():
                state.params[k].grad = v.to(state.params[k].device)
    state.step = int(jstate["step"])
    state.last_opt_step = int(jstate["last_opt_step"])
    state.ema_updates = int(jstate["ema_updates"])
    return state


def load_npz_state_dict(path) -> Dict[str, torch.Tensor]:
    """Load a torch-named state dict saved with ``np.savez`` (what
    ``tools/export_torch_sd.py`` writes from a JAX checkpoint)."""
    with np.load(path) as z:
        return {k: torch.from_numpy(z[k]) for k in z.files}


def load_state_dict(model: DeSeNet, sd: Mapping[str, torch.Tensor]) -> None:
    """Load ``sd`` into ``model``, allowing only the never-run BNs and BN
    step counters to be absent and only reference Detect anchor buffers to
    be extra. Raises on anything else."""
    sd = {k: v for k, v in sd.items()
          if not k.endswith((".anchors", ".anchor_grid"))}
    res = model.load_state_dict(sd, strict=False)
    allowed = set(model.quirk_bn_keys())
    missing = [k for k in res.missing_keys
               if k not in allowed and not k.endswith("num_batches_tracked")]
    if missing or res.unexpected_keys:
        raise KeyError(f"state dict does not match the model: missing "
                       f"{missing[:5]}, unexpected {res.unexpected_keys[:5]}")
