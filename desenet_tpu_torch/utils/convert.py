"""Weights and training state from the JAX package into the port.

A flax-free port of ``desenet_tpu/utils/torch_convert.py``
(``flax_path_to_torch_key`` with the name tables of every seg head,
``fused_csp_sources``, ``_conv_kernel_to_focus``) and of the layout
transposes of ``tools/export_torch_sd.py``, with the renames of the DSL
blocks whose JAX names are not the reference's (DWConv, CrossConv, the
Ghost blocks, C3TR's attention, the BatchNorm row). The JAX package's TPU
layouts are undone on the way: the fused C3 ``cv12``/``bn12`` split back
into ``cv1``/``cv2``, and the fused 6x6 stem conv becomes the Focus 3x3
conv over the slice-concat where the port model has a Focus row (a
FusedFocus row takes it as it is).
"""

from __future__ import annotations

import dataclasses
import functools
import re
from typing import Dict, List, Mapping, Tuple

import numpy as np
import torch

from desenet_tpu_torch.models.build import SEG_HEADS, DeSeNet, ModelSpec
from desenet_tpu_torch.train.optim import OptimConfig
from desenet_tpu_torch.train.state import TrainState, create_train_state
from desenet_tpu_torch.utils.checkpoint import (SCHEMA_VERSION, migrate_legacy,
                                                migrate_to_version)


def _rfb2_table(fpfx: str, tpfx: str, has_global: bool) -> Dict[str, str]:
    t = {
        f"{fpfx}/branch0_a/": f"{tpfx}.branch0.0/",
        f"{fpfx}/branch0_b/": f"{tpfx}.branch0.1/",
        f"{fpfx}/branch1/conv/conv2d/": f"{tpfx}.branch1.0/",
        f"{fpfx}/branch1/bn/bn/": f"{tpfx}.branch1.1/",
        f"{fpfx}/branch2/conv/conv2d/": f"{tpfx}.branch2.0/",
        f"{fpfx}/branch2/bn/bn/": f"{tpfx}.branch2.1/",
        f"{fpfx}/branch3/": f"{tpfx}.branch3.0/",
        f"{fpfx}/conv_linear/": f"{tpfx}.ConvLinear/",
    }
    if has_global:
        t[f"{fpfx}/branch4/conv/"] = f"{tpfx}.branch4.1/"
    return t


def _ffm_table(fpfx: str, tpfx: str) -> Dict[str, str]:
    return {
        f"{fpfx}/convblk/": f"{tpfx}.convblk/",
        f"{fpfx}/att_fc1/conv2d/": f"{tpfx}.channel_attention.1/",
        f"{fpfx}/att_fc2/conv2d/": f"{tpfx}.channel_attention.3/",
    }


def _head_table(head: str) -> Dict[str, str]:
    """flax sub-path prefix -> torch sub-path prefix inside a seg head row."""
    if head == "SegMaskPSP2":  # yolo.py:200-235
        t = {
            "stem/m8/": "m8.0/",
            "stem/m16/": "m16.0/",
            "stem/m32/": "m32.0/",
            "spatial_path/branch0_a/": "spatial_path.branch0.0/",
            "spatial_path/branch0_b/": "spatial_path.branch0.1/",
            "spatial_path/branch1/conv/conv2d/": "spatial_path.branch1.0/",
            "spatial_path/branch1/bn/bn/": "spatial_path.branch1.1/",
            "spatial_path/branch2/conv/conv2d/": "spatial_path.branch2.0/",
            "spatial_path/branch2/bn/bn/": "spatial_path.branch2.1/",
            "spatial_path/branch_global/conv/":
                "spatial_path.branch_global.1/",
            "spatial_path/conv_linear/": "spatial_path.ConvLinear/",
            "context_red/": "context_path.0/",
            "context_pp/": "context_path.1/",
            "out/conv2d/": "out.0/",
        }
        t.update(_ffm_table("ffm", "ffm"))
        return t
    if head == "SegMaskPSP":  # yolo.py:156-197
        t = {
            "stem/m8/": "m8.0/",
            "stem/m16/": "m16.0/",
            "stem/m32/": "m32.0/",
            "pp/": "out.1/",
            "out/conv2d/": "out.3/",
        }
        t.update(_rfb2_table("rfb", "out.0", has_global=False))
        t.update(_ffm_table("ffm", "out.2"))
        return t
    if head == "SegMaskBiSe":  # yolo.py:35-91
        t = {
            "m8/": "m8.0/",
            "up16_conv/": "up16.0/",
            "up32_conv/": "up32.0/",
            "out/conv2d/": "out.2/",
            "aux16_conv/": "aux16.0/",
            "aux16_out/conv2d/": "aux16.1/",
            "aux32_conv/": "aux32.0/",
            "aux32_out/conv2d/": "aux32.1/",
        }
        t.update(_rfb2_table("m16", "m16.0", has_global=False))
        t.update(_rfb2_table("m32", "m32.0", has_global=True))
        t.update(_ffm_table("ffm", "out.0"))
        return t
    if head == "SegMaskLab":  # yolo.py:98-129
        t = {
            "detail1/": "detail.0/",
            "detail2/": "detail.1/",
            "enc_red/": "encoder.0/",
            "aspp/branch0/": "encoder.1.branch0.0/",
            "aspp/branch4/conv/": "encoder.1.branch4.1/",
            "aspp/conv_linear/": "encoder.1.ConvLinear/",
            "dec_conv/": "decoder.1/",
            "out/conv2d/": "decoder.2/",
        }
        for b in (1, 2, 3):
            t[f"aspp/branch{b}/conv/conv2d/"] = f"encoder.1.branch{b}.0/"
            t[f"aspp/branch{b}/bn/bn/"] = f"encoder.1.branch{b}.1/"
        t.update(_ffm_table("ffm", "decoder.0"))
        return t
    if head == "SegMaskBase":  # yolo.py:134-153
        return {
            "c3/": "m.0/",
            "c3spp/": "m.1/",
            "out/conv2d/": "m.3/",
        }
    raise ValueError(head)


_HEAD_TABLES = {h: _head_table(h) for h in SEG_HEADS}

# regex rewrites of the flax sub-path inside rows whose JAX blocks are
# named otherwise than the reference's torch modules, applied in order
_GHOST_RULES = (
    (r"(^|/)sc_dw/conv/", r"\1shortcut/0/"),
    (r"(^|/)sc_pw/", r"\1shortcut/1/"),
    (r"(^|/)gc1/", r"\1conv/0/"),
    (r"(^|/)dw/conv/", r"\1conv/1/"),
    (r"(^|/)gc2/", r"\1conv/2/"),
)
_ROW_RULES = {
    "DWConv": ((r"^conv/", ""),),
    "BatchNorm": ((r"^bn/", ""),),
    "CrossConv": ((r"(^|/)(cv[12])_(conv|bn)/", r"\1\2/\3/"),),
    "GhostBottleneck": _GHOST_RULES,
    "C3Ghost": _GHOST_RULES,
    "C3TR": ((r"(^|/)tr_(\d+)/", r"\1tr/\2/"),),
}
# flax MultiHeadDotProductAttention leaves, merged into torch's
# nn.MultiheadAttention in_proj / out_proj
_MHA = re.compile(r"^(.*/ma)/(query|key|value|out)/(kernel|bias)$")

_LEAF = {
    "kernel": "weight",
    "scale": "weight",
    "bias": "bias",
    "mean": "running_mean",
    "var": "running_var",
}


def _is_fused_focus(path: Tuple[str, ...], spec: ModelSpec) -> bool:
    """A Focus row whose JAX variables are the fused 6x6 conv (one
    ConvBnAct at ``l{i}/conv`` + ``l{i}/bn``, the JAX package's default)
    rather than Focus's inner ConvBnAct (``l{i}/conv/conv`` +
    ``l{i}/conv/bn``). A FusedFocus row takes the fused ones as they are."""
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

    if ls.name in SEG_HEADS:
        for fp, tp in _HEAD_TABLES[ls.name].items():
            if inner.startswith(fp):
                inner = tp + inner[len(fp):]
                break
    elif ls.name == "Detect":
        inner = re.sub(r"^m(\d+)/", r"m.\1/", inner)
    else:
        if _is_fused_focus(path, spec):
            inner = "conv/" + inner
        for pat, rep in _ROW_RULES.get(ls.name, ()):
            inner = re.sub(pat, rep, inner)

    prefix = f"model.{li}." + (f"{seq}." if seq else "")
    return prefix + _torch_subkey(inner)


def _torch_subkey(inner: str) -> str:
    """A flax sub-path (``cv1/conv/conv2d/kernel``) as the torch sub-key
    (``cv1.conv.weight``): the JAX wrappers' ``conv2d`` and inner ``bn``
    levels dropped, ``m_0`` as ``m.0``, the leaf renamed (a leaf with no
    torch name, such as Sum's ``w``, keeps its own)."""
    leaf_src = inner.rsplit("/", 1)[-1]
    body = inner[: -(len(leaf_src) + 1)] if "/" in inner else ""
    body = body.replace("conv/conv2d", "conv")
    body = body.replace("bn/bn", "bn")
    body = re.sub(r"(^|/)conv2d($|/)", r"\1\2", body).strip("/")
    body = re.sub(r"m_(\d+)", r"m.\1", body)
    body = body.replace("/", ".")
    leaf = _LEAF.get(leaf_src, leaf_src)
    return f"{body}.{leaf}" if body else leaf


# flax sub-paths of the blocks the DSL cannot name (``models/layers.py``:
# ARM ... Sum) whose torch modules differ from the JAX ones: the global
# branch's ConvBnAct is index 1 of ``GlobalBranch``, a dilated branch's
# conv and BN are indices 0 and 1 of ``DilatedConvBnSiLU``, DAPPM's bare
# BNs drop the inner ``bn`` level
_BLOCK_RULES = (
    (r"^(branch\d+)/conv/(conv|bn)/", r"\1/1/\2/"),
    (r"^(branch\d+)/conv/conv2d/", r"\1/0/"),
    (r"^(branch\d+)/bn/bn/", r"\1/1/"),
    (r"(^|/)(\w+_bn)/bn/", r"\1\2/"),
)


def block_tree_from_jax(flat: Mapping[str, np.ndarray],
                        block: torch.nn.Module) -> Dict[str, torch.Tensor]:
    """One block's flax tree -> tensors under the block's state-dict keys,
    for the blocks the DSL cannot name (ARM, ASPPs, RFB1, DAPPM,
    ConvBNReLU, Classify, Sum).

    ``flat`` maps ``"params/conv/conv/conv2d/kernel"``-style paths (the
    block's ``flatten_dict(variables, sep="/")``, or any tree of that
    shape: gradients, ``batch_stats`` alone) to arrays. Raises on a key the
    block lacks or a shape that differs."""
    want = block.state_dict()
    out = {}
    for key, val in flat.items():
        col, inner = key.split("/", 1)
        if col not in ("params", "batch_stats"):
            raise KeyError(f"unexpected collection in {key}")
        for pat, rep in _BLOCK_RULES:
            inner = re.sub(pat, rep, inner)
        val = np.asarray(val)
        val = val if val.dtype == np.float64 else val.astype(np.float32)
        tkey = _torch_subkey(inner)
        if tkey not in want:
            raise KeyError(f"{key} maps to {tkey!r}, which the block lacks")
        t = torch.tensor(to_torch_tensor(val, inner.rsplit("/", 1)[-1]))
        if tuple(t.shape) != tuple(want[tkey].shape):
            raise ValueError(f"shape mismatch for {tkey}: {tuple(t.shape)} "
                             f"vs {tuple(want[tkey].shape)}")
        out[tkey] = t
    return out


def block_state_dict_from_jax(flat: Mapping[str, np.ndarray],
                              block: torch.nn.Module
                              ) -> Dict[str, torch.Tensor]:
    """One block's flax variables (``params`` and ``batch_stats``) -> its
    whole state dict (``block_tree_from_jax``). BNs that never run
    (``block.quirk_bn_prefixes()``) have no JAX variables and keep the
    block's values; step counters are 0. Raises where any other key has no
    JAX variable."""
    out = block_tree_from_jax(flat, block)
    quirk = tuple(getattr(block, "quirk_bn_prefixes", lambda: [])())
    for k, v in block.state_dict().items():
        if k.endswith("num_batches_tracked"):
            out[k] = torch.zeros_like(v)
        elif k not in out:
            if not k.startswith(quirk):
                raise KeyError(f"no JAX variable for {k}")
            out[k] = v.clone()
    return out


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
    momentum buffers, EMA copies. Fused C3 leaves split into ``cv1``/``cv2``,
    the fused stem kernel becomes the Focus conv's, and the
    attention's query/key/value/out leaves merge into torch's in_proj and
    out_proj, each element to one element, so a gradient or buffer crosses
    as its parameter does."""
    out: Dict[str, np.ndarray] = {}
    mha: Dict[str, Dict[Tuple[str, str], np.ndarray]] = {}
    for key, val in flat.items():
        path = tuple(key.split("/"))
        val = np.asarray(val)
        val = val if val.dtype == np.float64 else val.astype(np.float32)
        fs = fused_csp_sources(path)
        m = _MHA.match(key)
        if m is not None:  # merged below, once the four parts are in
            mha.setdefault(m.group(1), {})[m.group(2, 3)] = val
        elif fs is not None:  # split fused C3 cv12/bn12 back into cv1+cv2
            p1, p2, ax = fs
            v1, v2 = np.split(val, [val.shape[ax] // 2], axis=ax)
            out[flax_path_to_torch_key(p1, spec)] = to_torch_tensor(v1, path[-1])
            out[flax_path_to_torch_key(p2, spec)] = to_torch_tensor(v2, path[-1])
        elif _is_fused_focus(path, spec) and path[-1] == "kernel":
            out[flax_path_to_torch_key(path, spec)] = _conv_kernel_to_focus(val)
        else:
            out[flax_path_to_torch_key(path, spec)] = to_torch_tensor(
                val, path[-1])
    for prefix, parts in mha.items():
        # flax: query/key/value kernels (E, heads, head_dim), biases (heads,
        # head_dim); out kernel (heads, head_dim, E). torch: in_proj_weight
        # (3E, E) = [Wq; Wk; Wv] with y = x W^T, heads major in each
        # E-sized block, as flax's (heads, head_dim) flattens
        tkey = flax_path_to_torch_key(tuple(f"{prefix}/kernel".split("/")),
                                      spec)[:-len("weight")]
        e = parts["query", "kernel"].shape[0]
        qkv = ("query", "key", "value")
        out[tkey + "in_proj_weight"] = np.concatenate(
            [parts[n, "kernel"].reshape(e, -1).T for n in qkv])
        out[tkey + "in_proj_bias"] = np.concatenate(
            [parts[n, "bias"].reshape(-1) for n in qkv])
        out[tkey + "out_proj.weight"] = parts["out", "kernel"].reshape(-1, e).T
        out[tkey + "out_proj.bias"] = parts["out", "bias"]
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


def _unflatten(flat: Mapping[str, np.ndarray]) -> dict:
    """``"params/l0/conv/conv2d/kernel"``-style paths -> nested dicts."""
    tree: dict = {}
    for key, val in flat.items():
        *path, leaf = key.split("/")
        node = tree
        for p in path:
            node = node.setdefault(p, {})
        node[leaf] = val
    return tree


def _flatten(tree: Mapping, prefix: str = "") -> Dict[str, np.ndarray]:
    """The inverse of ``_unflatten``."""
    out = {}
    for k, v in tree.items():
        if isinstance(v, Mapping):
            out.update(_flatten(v, f"{prefix}{k}/"))
        else:
            out[prefix + k] = v
    return out


def state_dict_from_jax(flat: Mapping[str, np.ndarray], spec: ModelSpec,
                        schema_version=SCHEMA_VERSION
                        ) -> Tuple[Dict[str, torch.Tensor], List[str]]:
    """JAX variables -> the port's state dict.

    ``flat`` maps ``"params/l4/m_0/cv1/conv/conv2d/kernel"``-style paths
    (``flax.traverse_util.flatten_dict(variables, sep="/")``, done by the
    caller) to arrays; fused and unfused C3 layouts are both accepted.
    ``schema_version`` is the tree's checkpoint schema (meta.json's
    ``schema_version``): an older one is first migrated to the current one
    (``utils/checkpoint.migrate_to_version``), None (an unversioned tree)
    goes through ``migrate_legacy``, as the JAX package's
    ``load_inference_variables`` does.
    Returns ``(state_dict, unfilled)``: ``unfilled`` lists the port model's
    keys that the JAX variables do not cover, which for a valid checkpoint
    are exactly ``DeSeNet.quirk_bn_keys()`` (BNs that never run keep their
    init), and for variables from an eval-mode init also
    ``DeSeNet.train_only_keys()``."""
    if schema_version is None:
        flat = _flatten(migrate_legacy(_unflatten(flat)))
    elif schema_version != SCHEMA_VERSION:
        flat = _flatten(migrate_to_version(_unflatten(flat), schema_version))
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


def focus_to_fused(sd: Mapping[str, torch.Tensor], spec: ModelSpec
                   ) -> Dict[str, torch.Tensor]:
    """``sd`` with the Focus-layout weights of ``spec``'s FusedFocus rows
    (``model.{i}.conv.conv.weight``, ``model.{i}.conv.bn.*``) in the fused
    layout (``model.{i}.conv.weight``, ``model.{i}.bn.*``): the kxk kernel
    over the slice-concat becomes the (2k)x(2k) one over the image, tap
    (2*di + oy, 2*dj + ox) taking slice oy + 2*ox's tap (di, dj)
    (``utils/fold._focus_kernel_to_conv``). Other keys pass through."""
    out = dict(sd)
    for ls in spec.layers:
        pre = f"model.{ls.i}.conv."
        if ls.name != "FusedFocus" or pre + "conv.weight" not in out:
            continue
        for k in [k for k in out if k.startswith(pre)]:
            v, rest = out.pop(k), k[len(pre):]
            if rest != "conv.weight":  # the BN's leaves
                out[f"model.{ls.i}.{rest}"] = v
                continue
            o, c4, kk, _ = v.shape
            c = c4 // 4
            w = v.new_zeros(o, c, 2 * kk, 2 * kk)
            for oy in range(2):
                for ox in range(2):
                    s = oy + 2 * ox
                    w[:, :, oy::2, ox::2] = v[:, c * s:c * (s + 1)]
            out[f"model.{ls.i}.conv.weight"] = w
    return out


def fused_to_focus(sd: Mapping[str, torch.Tensor], spec: ModelSpec
                   ) -> Dict[str, torch.Tensor]:
    """The inverse of ``focus_to_fused``: ``sd`` with the fused-layout
    weights of ``spec``'s Focus and FusedFocus rows
    (``model.{i}.conv.weight``, ``model.{i}.bn.*``) in the Focus layout
    (``model.{i}.conv.conv.weight``, ``model.{i}.conv.bn.*``), the
    reference's; slice oy + 2*ox's tap (di, dj) is the fused kernel's tap
    (2*di + oy, 2*dj + ox). Other keys pass through."""
    out = dict(sd)
    for ls in spec.layers:
        pre = f"model.{ls.i}."
        if (ls.name not in ("Focus", "FusedFocus")
                or pre + "conv.weight" not in out):
            continue
        for k in [k for k in out if k.startswith(pre)]:
            v, rest = out.pop(k), k[len(pre):]
            if rest != "conv.weight":  # the BN's leaves
                out[pre + "conv." + rest] = v
                continue
            o, c, kk, _ = v.shape
            w = v.new_empty(o, 4 * c, kk // 2, kk // 2)
            for oy in range(2):
                for ox in range(2):
                    s = oy + 2 * ox
                    w[:, c * s:c * (s + 1)] = v[:, :, oy::2, ox::2]
            out[pre + "conv.conv.weight"] = w
    return out


def quant_cfg_from_jax(cfg) -> "QuantCfg":
    """The JAX package's ``QuantCfg`` (or any object with its fields) as the
    port's: the site keys are the same flax scope paths, so its calibrated
    ``scales`` and ``in_means`` carry over as they are."""
    from desenet_tpu_torch.quant import QuantCfg

    return QuantCfg(**{f.name: getattr(cfg, f.name)
                       for f in dataclasses.fields(QuantCfg)})


def load_state_dict(model: DeSeNet, sd: Mapping[str, torch.Tensor]) -> None:
    """Load ``sd`` into ``model``, allowing only the never-run BNs, the
    training-only modules (``DeSeNet.train_only_keys``) and BN step counters
    to be absent and only reference Detect anchor buffers to be extra.
    Raises on anything else. Focus-layout weights load into a FusedFocus
    row (``focus_to_fused``)."""
    sd = {k: v for k, v in focus_to_fused(sd, model.spec).items()
          if not k.endswith((".anchors", ".anchor_grid"))}
    res = model.load_state_dict(sd, strict=False)
    allowed = set(model.quirk_bn_keys() + model.train_only_keys())
    missing = [k for k in res.missing_keys
               if k not in allowed and not k.endswith("num_batches_tracked")]
    if missing or res.unexpected_keys:
        raise KeyError(f"state dict does not match the model: missing "
                       f"{missing[:5]}, unexpected {res.unexpected_keys[:5]}")
