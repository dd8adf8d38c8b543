"""Post-training int8 (W8A8) inference quantization.

Counterpart of ``desenet_tpu/quant.py``: static activation scales
calibrated on a few batches, per-output-channel int8 weights, BatchNorm
folded into each conv's epilogue, int8 glue (max pool, nearest upsample,
channel slices and concats, bilinear resizes and average pools at the input
scale), bias correction, the MSE weight-clip search and the weights-only
ablation.

- ``QTensor`` is int8 data (NCHW, channels_last on the card) and a static
  scale: a Python float (per tensor) or a tuple of floats, one a channel
  along dim 1 (``Scale``). A plain class, not a tensor subclass.
- Calibration records its statistics into a dict that the forward fills
  (``recording``), keyed by the JAX package's flax scope paths (``l0/in``,
  ``l4/m_1/cv2/out``, ``l24/ffm/gate``): every quant-aware module carries
  its JAX path in ``qkey`` (``models.layers.set_quant``), so a
  ``scales`` / ``in_means`` pair calibrated by the JAX package drops into
  this package's ``QuantCfg`` unchanged.
- The conv itself is ``ops/int8_conv.py``: its plain version on a CPU
  tensor, the kernel ``csrc/int8_conv.cu`` on a CUDA tensor.
"""

from __future__ import annotations

import contextlib
import contextvars
import dataclasses
import functools
from typing import Dict, Optional, Sequence, Tuple, Union

import numpy as np
import torch
import torch.nn.functional as F

QMAX = 127.0

# A scale is a Python float (per tensor) or a tuple of floats (one a
# channel, dim 1 of an NCHW tensor).
Scale = Union[float, Tuple[float, ...]]

# jnp.linspace(0.55, 1.0, 10) in float32, the MSE clip search's grid (its
# third value is not np.linspace's rounded to float32)
MSE_CLIP_RATIOS = (0.550000011920929, 0.6000000238418579, 0.6500000357627869,
                   0.699999988079071, 0.75, 0.800000011920929,
                   0.8500000238418579, 0.8999999761581421, 0.949999988079071,
                   1.0)


# float8 storage (``act_store``): the dtypes, and the e4m3fn rounding
# midpoint above its largest value 448, past which JAX's cast gives NaN
# (e4m3fn has no infinity) where torch's saturates to 448
F8_DTYPES = (torch.float8_e4m3fn, torch.float8_e5m2)
E4M3_NAN_ABOVE = 464.0


def to_f8(x: torch.Tensor, dtype) -> torch.Tensor:
    """Cast to a float8 dtype as JAX does: for e4m3fn, NaN where |x|
    rounds past 448 (above 464, infinities included)."""
    if dtype == torch.float8_e4m3fn:  # a masked fill always: no host sync
        x = x.masked_fill(x.abs() > E4M3_NAN_ABOVE, float("nan"))
    return x.to(dtype)


def scale_vec(s: Scale, c: int) -> np.ndarray:
    """Scale as an explicit length-c float32 vector."""
    if isinstance(s, tuple):
        v = np.asarray(s, np.float32)
        assert v.shape == (c,), (v.shape, c)
        return v
    return np.full(c, s, np.float32)


def scale_max(s: Scale) -> float:
    return float(np.max(s)) if isinstance(s, tuple) else float(s)


@functools.lru_cache(maxsize=4096)
def scale_t(s: Scale, device) -> torch.Tensor:
    """Scale as an f32 tensor on ``device`` broadcastable over NCHW: a 0-d
    tensor, or (C, 1, 1). Made once for each scale and device: the scales
    of a model are constants (never written to)."""
    if isinstance(s, tuple):
        return torch.tensor(s, dtype=torch.float32, device=device).view(
            -1, 1, 1)
    return torch.tensor(s, dtype=torch.float32, device=device)


class QTensor:
    """int8 activation tensor with a static symmetric scale: real value =
    data * scale (per tensor, or per channel along dim 1). Not a tuple
    subclass: layer code tells "a list of inputs" from "one quantized
    input" with isinstance checks."""

    __slots__ = ("data", "scale")

    def __init__(self, data: torch.Tensor, scale: Scale):
        self.data = data
        self.scale = scale

    def __repr__(self):
        s = (f"{len(self.scale)} channel scales"
             if isinstance(self.scale, tuple) else f"scale={self.scale}")
        return f"QTensor({tuple(self.data.shape)}, {s})"


@dataclasses.dataclass(frozen=True)
class QuantCfg:
    """Static quantization config, the JAX package's fields and defaults.

    mode "calib": the fp path, every site records its statistics;
    "int8": the quantized path on ``scales``. ``scales``: ((site_key,
    scale), ...), scale = range / 127; ``in_means``: ((site_key, channel
    means), ...) for bias correction."""

    mode: str = "calib"
    scales: Tuple[Tuple[str, Scale], ...] = ()
    calib_pct: float = 99.9
    in_means: Tuple[Tuple[str, Tuple[float, ...]], ...] = ()
    bias_correct: bool = False
    mse_clip: bool = False
    per_channel_act: bool = False
    weights_only: bool = False

    @functools.cached_property
    def _scales(self) -> dict:
        return dict(self.scales)

    @functools.cached_property
    def _in_means(self) -> dict:
        return dict(self.in_means)

    def scale_for(self, key: str) -> Scale:
        d = self._scales
        if key not in d:
            raise KeyError(
                f"no calibrated scale for site {key!r}; re-run calibration "
                f"({len(d)} sites known)")
        return d[key]

    def mean_for(self, key: str) -> Optional[np.ndarray]:
        """Calibrated per-channel input mean of a conv site, or None where
        there is none or bias correction is off."""
        if not self.bias_correct:
            return None
        v = self._in_means.get(key)
        return None if v is None else np.asarray(v, np.float32)

    @property
    def is_calib(self) -> bool:
        return self.mode == "calib"

    @property
    def is_int8(self) -> bool:
        return self.mode == "int8" and not self.weights_only

    @property
    def is_w8(self) -> bool:
        """Weights-only quantization (fp activations)."""
        return self.mode == "int8" and self.weights_only


def quantize(x: torch.Tensor, scale: Scale) -> QTensor:
    """fp tensor -> QTensor at ``scale`` (round half to even, saturate)."""
    q = torch.clamp(torch.round(x.float() / scale_t(scale, x.device)),
                    -QMAX, QMAX)
    return QTensor(q.to(torch.int8), scale)


def dequantize(x, dtype=torch.float32):
    if isinstance(x, QTensor):
        return (x.data.float() * scale_t(x.scale, x.data.device)).to(dtype)
    return x


def requantize(x: QTensor, scale: Scale) -> QTensor:
    """Change a QTensor's scale (exact where scale >= x.scale)."""
    if scale == x.scale:
        return x
    dev = x.data.device
    r = x.data.float() * (scale_t(x.scale, dev) / scale_t(scale, dev))
    return QTensor(torch.clamp(torch.round(r), -QMAX, QMAX).to(torch.int8),
                   scale)


def qt_slice(x: QTensor, lo: int, hi: int) -> QTensor:
    """Channel slice [lo:hi] (a view) with the matching scale slice."""
    s = x.scale[lo:hi] if isinstance(x.scale, tuple) else x.scale
    return QTensor(x.data[:, lo:hi], s)


def qt_concat(xs: Sequence) -> Union[QTensor, torch.Tensor]:
    """Channel concat. Per-tensor scales: every part requantized to the
    largest part scale, then concatenated. Per-channel scales anywhere: the
    data concatenated and the scale vectors with it."""
    if not any(isinstance(x, QTensor) for x in xs):
        return torch.cat(list(xs), 1)
    assert all(isinstance(x, QTensor) for x in xs), "mixed QT/fp concat"
    if any(isinstance(x.scale, tuple) for x in xs):
        s = tuple(float(v) for x in xs
                  for v in scale_vec(x.scale, x.data.shape[1]))
        return QTensor(torch.cat([x.data for x in xs], 1), s)
    s = max(x.scale for x in xs)
    return QTensor(torch.cat([requantize(x, s).data for x in xs], 1), s)


def qt_add(a: QTensor, b: QTensor, out_scale: Scale) -> QTensor:
    """Residual add of two QTensors, requantized at ``out_scale``."""
    dev = a.data.device
    y = (a.data.float() * scale_t(a.scale, dev)
         + b.data.float() * scale_t(b.scale, dev))
    return QTensor(torch.clamp(torch.round(y / scale_t(out_scale, dev)),
                               -QMAX, QMAX).to(torch.int8), out_scale)


def quantize_kernel(w: torch.Tensor, mse_clip: bool = False):
    """OIHW float kernel -> (int8 kernel, per-output-channel f32 scale
    (O,)). Symmetric per channel: s_w[o] = absmax(w[o]) / 127; with
    ``mse_clip`` the scale is absmax / 127 times the ratio of
    ``MSE_CLIP_RATIOS`` that minimizes the channel's reconstruction error
    (the first of equal ones)."""
    w = w.float()
    absmax = w.abs().amax(dim=(1, 2, 3))
    s_abs = torch.clamp(absmax, min=1e-12) / QMAX
    if not mse_clip:
        qw = torch.clamp(torch.round(w / s_abs.view(-1, 1, 1, 1)), -QMAX, QMAX)
        return qw.to(torch.int8), s_abs
    best_err = torch.full_like(absmax, float("inf"))
    best_s = s_abs
    for r in MSE_CLIP_RATIOS:
        s = s_abs * torch.tensor(r, dtype=torch.float32, device=w.device)
        q = torch.clamp(torch.round(w / s.view(-1, 1, 1, 1)), -QMAX, QMAX)
        err = ((q * s.view(-1, 1, 1, 1) - w) ** 2).sum(dim=(1, 2, 3))
        take = err < best_err
        best_err = torch.where(take, err, best_err)
        best_s = torch.where(take, s, best_s)
    qw = torch.clamp(torch.round(w / best_s.view(-1, 1, 1, 1)), -QMAX, QMAX)
    return qw.to(torch.int8), best_s


def bn_fold_constants(bn) -> Tuple[torch.Tensor, torch.Tensor]:
    """An eval BatchNorm -> (scale, bias) f32 vectors: gamma / sqrt(var +
    eps) and beta - mean * scale (eps 1e-3 on the port's BNs)."""
    gamma = bn.weight.detach().float()
    beta = bn.bias.detach().float()
    mu = bn.running_mean.float()
    var = bn.running_var.float()
    s = gamma * torch.rsqrt(var + torch.tensor(bn.eps, dtype=torch.float32,
                                               device=var.device))
    return s, beta - mu * s


def qt_resize_bilinear(x: QTensor, out_hw, align_corners: bool) -> QTensor:
    """Bilinear resize of a QTensor at the same scale (a convex
    combination: no clipping beyond rounding), as the JAX package computes
    it: the separable contraction in f32, then round."""
    from desenet_tpu_torch.ops.resize import resize_bilinear_separable

    y = resize_bilinear_separable(x.data.float(), out_hw, align_corners)
    return QTensor(torch.clamp(torch.round(y), -QMAX, QMAX).to(torch.int8),
                   x.scale)


def qt_global_avg_pool(x: QTensor, out_k=1) -> QTensor:
    """Adaptive average pool of a QTensor at the same scale."""
    from desenet_tpu_torch.ops.resize import adaptive_avg_pool_separable

    y = adaptive_avg_pool_separable(x.data.float(), out_k)
    return QTensor(torch.clamp(torch.round(y), -QMAX, QMAX).to(torch.int8),
                   x.scale)


def qt_upsample_nearest(x: QTensor, scale: int) -> QTensor:
    """Integer-factor nearest upsample of a QTensor (F.interpolate has no
    int8 kernel): each pixel repeated, channels_last kept."""
    from desenet_tpu_torch.ops.resize import upsample_nearest_repeat

    return QTensor(upsample_nearest_repeat(x.data, scale), x.scale)


def qt_max_pool(x: QTensor, k: int) -> QTensor:
    """MaxPool2d(k, 1, k // 2) of the int8 data (max commutes with the
    positive scale). CUDA's max pool takes no int8: there it pools the
    values as float16, which holds every int8 exactly."""
    d = x.data
    if d.is_cuda:
        return QTensor(F.max_pool2d(d.half(), k, 1, k // 2).to(torch.int8),
                       x.scale)
    return QTensor(F.max_pool2d(d, k, 1, k // 2), x.scale)


# ---------------------------------------------------------------------------
# calibration: the forward of a model in mode "calib" records into the dict
# that ``recording`` installs

_RECORD: contextvars.ContextVar = contextvars.ContextVar(
    "desenet_torch_qcal", default=None)


@contextlib.contextmanager
def recording(stats: dict):
    """Collect the calibration statistics of the forwards inside the block
    into ``stats``: {site_key: ("range", tensor)} for the range sites
    (max-reduced within a forward) and {site_key: ("mean", tensor)} for the
    channel means (summed)."""
    token = _RECORD.set(stats)
    try:
        yield stats
    finally:
        _RECORD.reset(token)


def site_key(mod, site: str) -> str:
    """``site`` under the module's JAX scope path (a top-level module's
    sites are bare, as flax joins an empty path)."""
    return f"{mod.qkey}/{site}" if mod.qkey else site


def percentile(a: torch.Tensor, pct: float) -> torch.Tensor:
    """``jnp.percentile(a, pct)`` (linear interpolation, float32 index
    arithmetic) of all of ``a``'s values: the two order statistics from a
    top-k of the upper tail, so it works where ``torch.quantile`` refuses
    (over 2^24 elements) and sorts only the tail."""
    a = a.reshape(-1).float()
    n = a.numel()
    q = np.float32(pct) / np.float32(100.0)
    qi = np.float32(q * np.float32(n - 1))
    lo_i = float(np.floor(qi))
    hi_i = float(np.ceil(qi))
    hw = np.float32(qi - np.float32(lo_i))
    lw = np.float32(np.float32(1.0) - hw)
    lo = int(min(max(lo_i, 0), n - 1))
    hi = int(min(max(hi_i, 0), n - 1))
    top = torch.topk(a, n - lo, sorted=True).values  # descending
    lo_v, hi_v = top[n - lo - 1], top[n - hi - 1]
    return lo_v * float(lw) + hi_v * float(hw)


def _record(key: str, kind: str, v: torch.Tensor) -> None:
    stats = _RECORD.get()
    if stats is None:
        return
    prev = stats.get(key)
    if prev is None:
        stats[key] = (kind, v)
    elif kind == "range":
        stats[key] = (kind, torch.maximum(prev[1], v))
    else:
        stats[key] = (kind, prev[1] + v)


def sow_absmax(mod, site: str, y: torch.Tensor) -> None:
    """Record the range of |y| at ``site``: the ``calib_pct`` percentile
    (absmax at 100); per channel (the channel absmax clipped at the global
    percentile) when ``per_channel_act``."""
    a = y.detach().float().abs()
    q = mod.quant
    pct = q.calib_pct
    if q.per_channel_act:
        stat = a.amax(dim=(0, 2, 3))
        if pct < 100.0:
            stat = torch.minimum(stat, percentile(a, pct))
    else:
        stat = a.amax() if pct >= 100.0 else percentile(a, pct)
    _record(site_key(mod, site), "range", stat)


def sow_in_range(mod, site: str, parts) -> None:
    """Record the range of a conv input (the channel concat of ``parts``):
    the absmax, or with ``per_channel_act`` the per-channel vector (each
    part's channel absmax clipped at that part's percentile)."""
    q = mod.quant
    if q.per_channel_act:
        vecs = []
        for v in parts:
            a = v.detach().float().abs()
            m = a.amax(dim=(0, 2, 3))
            if q.calib_pct < 100.0:
                m = torch.minimum(m, percentile(a, q.calib_pct))
            vecs.append(m)
        stat = torch.cat(vecs)
    else:
        stat = torch.stack([v.detach().float().abs().amax()
                            for v in parts]).amax()
    _record(site_key(mod, site), "range", stat)


def sow_channel_mean(mod, site: str, parts) -> None:
    """Record the per-channel mean of a conv input (summed over calls)."""
    m = torch.cat([p.detach().float().mean(dim=(0, 2, 3)) for p in parts])
    _record(site_key(mod, site), "mean", m)


def _to_scale(v: np.ndarray) -> Scale:
    if v.ndim == 0:
        return max(float(v), 1e-8) / QMAX
    return tuple(float(x) for x in np.maximum(v, 1e-8) / QMAX)


@torch.no_grad()
def calibrate_stats(model, batches):
    """Run ``batches`` (NCHW float images in [0, 1], on the model's device)
    through a model built with ``QuantCfg(mode="calib")``; return the
    static (scales, in_means) tuples for ``QuantCfg(mode="int8")``. Scales
    are max-reduced over the batches, means averaged."""
    acc: Dict[str, Scale] = {}
    mean_acc: Dict[str, np.ndarray] = {}
    n = 0
    for x in batches:
        stats: dict = {}
        with recording(stats):
            model(x)
        for k, (kind, v) in stats.items():
            a = v.detach().cpu().numpy().astype(np.float64)
            if kind == "mean":
                mean_acc[k] = mean_acc.get(k, 0.0) + a
                continue
            s = _to_scale(a)
            prev = acc.get(k)
            if prev is None:
                acc[k] = s
            elif isinstance(s, tuple):
                acc[k] = tuple(float(x) for x in
                               np.maximum(np.asarray(prev), np.asarray(s)))
            else:
                acc[k] = max(prev, s)
        n += 1
    scales = tuple(sorted(acc.items()))
    in_means = tuple(sorted(
        (k, tuple(float(x) for x in v / max(n, 1)))
        for k, v in mean_acc.items()))
    return scales, in_means


def quantize_for_inference(cfg, state_dict, calib_batches, bias_correct=True,
                           mse_clip=False, weights_only=False,
                           per_channel_act=True, device="cuda",
                           compute_dtype=torch.float32, **build_kw):
    """One-call PTQ: build ``cfg`` in calibration mode with
    ``state_dict``, calibrate on ``calib_batches`` (NCHW f32 images in [0,
    1]), rebuild in int8 mode with the scales. The parameters stay f32 (the
    int8 weights come from f32 ones, as in the JAX package); the input and
    the fp pieces run in ``compute_dtype``. Returns (int8 model on
    ``device``, spec, scales): the card unless the caller asks for the CPU
    (RuntimeError where there is no card). ``build_kw`` goes to
    ``build_model`` (nc, se_nc, anchors, det_fp_hops, fuse_focus,
    seg_upsample); FusedFocus is the default stem, as the JAX package's."""
    from desenet_tpu_torch.models import build_model
    from desenet_tpu_torch.utils.convert import load_state_dict

    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"device {device}: torch finds no CUDA card; "
                           "pass device='cpu' to quantize on the CPU")
    build_kw.setdefault("fuse_focus", True)
    mf = (torch.channels_last if device.type == "cuda"
          else torch.contiguous_format)

    def built(quant):
        model, spec = build_model(cfg, quant=quant,
                                  compute_dtype=compute_dtype, **build_kw)
        load_state_dict(model, state_dict)
        return model.to(device, torch.float32, memory_format=mf), spec

    calib_model, _ = built(QuantCfg(mode="calib",
                                    per_channel_act=per_channel_act))
    scales, in_means = calibrate_stats(
        calib_model, [x.to(device, torch.float32).contiguous(
            memory_format=mf) for x in calib_batches])
    del calib_model
    model, spec = built(QuantCfg(
        mode="int8", scales=scales, in_means=in_means,
        bias_correct=bias_correct, mse_clip=mse_clip,
        weights_only=weights_only, per_channel_act=per_channel_act))
    return model, spec, scales
