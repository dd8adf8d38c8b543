"""Height-sharded feature maps: what GSPMD inserts between the bands of a
``(data, spatial)`` mesh, written out for processes that each hold one
band.

Under ``scope(mesh, height)`` every NCHW map that the model's trunk and
heads carry is this rank's band of the global map: the rows of its
``band_counts`` share at the map's stride (a rank with 11 of 21 bands of
32 image rows holds 11 rows at stride 32, 44 at stride 8). The
primitives, each a ``torch.autograd.Function`` whose forward and backward
are ``all_reduce``s of dense buffers over the spatial group (gloo takes
them on CUDA tensors too, where NCCL refuses two ranks of one card and
``torch.distributed.nn``'s all-gather backward needs ``all_to_all``):

- ``rows(x, spans)``: the global rows ``spans[r]`` on every rank ``r``
  (an align_corners resize of a band needs a few rows past it); the
  backward sends each fetched row's gradient back to its owner and adds
  it there;
- ``halo(x, top, bottom, fill)``: the band with ``top`` rows above and
  ``bottom`` below, ``fill`` beyond the image's edges (0 for a conv's
  zero padding, -inf for a max pool's); a halo wider than a neighbour's
  band takes rows from further ranks (SPP's 13x13 pool needs 6 rows, a
  band at stride 32 may hold 2);
- ``spatial_sum(x)``: ``x`` summed over the spatial group (the global and
  adaptive pools' partial sums), its gradient summed back;
- ``gather_rows(x)``: the whole map on every spatial rank (the heads'
  outputs, so that the losses, the decode and NMS run as on one device);
  its backward adds the ranks' gradients and keeps the band's rows.

and the window ops built on them, each sized from the op's own kernel,
stride, padding and dilation: ``conv2d`` (a same-padded conv of a band,
stride 2 included) and ``max_pool_same``. Every rank holds the whole of
what it computes after ``gather_rows``, so the gradient of the sum of the
ranks' losses reaches each band once from each rank: the training step
scales its loss by ``1 / spatial`` (``train/step.py``).

Outside a scope every primitive is the identity (``halo`` the padding of
a whole map) and the model's layers take none of these paths, so the
one-process program runs exactly the ops it runs without this module.
"""

from __future__ import annotations

import contextlib
import contextvars
from dataclasses import dataclass
from typing import List, Optional, Sequence, Tuple

import torch
import torch.distributed as dist
import torch.nn.functional as F

from desenet_tpu_torch.parallel.mesh import Mesh, band_counts

__all__ = ["scope", "reenter", "current", "active", "band_of", "rows",
           "halo", "spatial_sum", "gather_rows", "conv2d", "max_pool_same"]


@dataclass(frozen=True)
class SpatialCtx:
    """The mesh and the band counts of one forward's images."""

    mesh: Mesh
    bands: Tuple[int, ...]

    @property
    def group(self):
        return self.mesh.spatial_group

    @property
    def me(self) -> int:
        return self.mesh.spatial_index


_CTX: contextvars.ContextVar = contextvars.ContextVar(
    "desenet_torch_spatial", default=None)


@contextlib.contextmanager
def scope(mesh: Mesh, height: int, max_stride: int = 32):
    """Run the model's forward (and its losses) on height bands of images
    of ``height`` rows: this rank holds ``band_counts(height,
    mesh.spatial, max_stride)[mesh.spatial_index]`` bands. A mesh with no
    spatial axis gives a no-op scope."""
    if mesh.spatial <= 1:
        yield None
        return
    if mesh.spatial_group is None:
        raise ValueError("a spatial mesh needs a process group "
                         "(make_mesh inside an initialized group)")
    ctx = SpatialCtx(mesh, band_counts(height, mesh.spatial, max_stride))
    token = _CTX.set(ctx)
    try:
        yield ctx
    finally:
        _CTX.reset(token)


@contextlib.contextmanager
def reenter(ctx: Optional[SpatialCtx]):
    """Run under a context ``current()`` returned earlier (None: no
    scope), e.g. in a recompute on another thread."""
    token = _CTX.set(ctx)
    try:
        yield
    finally:
        _CTX.reset(token)


def current() -> Optional[SpatialCtx]:
    """The scope's context, or None (always None while torch compiles or
    exports a program, which never runs under a scope)."""
    if torch.compiler.is_compiling():
        return None
    return _CTX.get()


def active() -> bool:
    return current() is not None


def band_of(ctx: SpatialCtx, h_local: int) -> Tuple[List[int], List[int], int]:
    """(first rows, end rows of every rank's band, global height) of a
    banded map whose band on this rank has ``h_local`` rows."""
    f, r = divmod(h_local, ctx.bands[ctx.me])
    if r or f == 0:
        raise ValueError(f"a map of {h_local} rows is no band of "
                         f"{ctx.bands[ctx.me]} strides")
    starts, acc = [], 0
    for b in ctx.bands:
        starts.append(acc * f)
        acc += b
    stops = [s + b * f for s, b in zip(starts, ctx.bands)]
    return starts, stops, acc * f


def _acc_dtype(dt: torch.dtype) -> torch.dtype:
    """The dtype of a collective's buffer: at least f32 (gloo sums no
    half types, and one owner a row keeps the copy exact)."""
    return torch.promote_types(dt, torch.float32)


class _Rows(torch.autograd.Function):
    """Global rows ``spans[r]`` of a banded map on every rank ``r``: one
    buffer of the rows each rank lacks, every owner writing its own, one
    all_reduce; the rank's own rows join them locally. One output on
    every rank, so that every rank runs the backward's all_reduce."""

    @staticmethod
    def forward(ctx, x, starts, stops, spans, me, group):
        n, c, _, w = x.shape
        segs, mine, off = [], {}, 0
        for r, ((a, b), s, e) in enumerate(zip(spans, starts, stops)):
            for side, (g0, g1) in (("pre", (a, min(b, s))),
                                   ("post", (max(a, e), b))):
                if g0 < g1:
                    segs.append((off, g0, g1))
                    if r == me:
                        mine[side] = (off, g1 - g0)
                    off += g1 - g0
        s, e = starts[me], stops[me]
        a, b = spans[me]
        keep = (max(a, s) - s, max(min(b, e) - s, max(a, s) - s))
        buf = x.new_zeros((n, c, off, w), dtype=_acc_dtype(x.dtype))
        for o, g0, g1 in segs:
            i0, i1 = max(g0, s), min(g1, e)
            if i0 < i1:
                buf[:, :, o + i0 - g0:o + i1 - g0] = x[:, :, i0 - s:i1 - s]
        if off:
            dist.all_reduce(buf, group=group)
        parts = []
        if "pre" in mine:
            o, k = mine["pre"]
            parts.append(buf[:, :, o:o + k].to(x.dtype))
        parts.append(x[:, :, keep[0]:keep[1]])
        if "post" in mine:
            o, k = mine["post"]
            parts.append(buf[:, :, o:o + k].to(x.dtype))
        ctx.geom = (segs, mine, off, s, e, keep, group, x.shape, x.dtype)
        return torch.cat(parts, 2) if len(parts) > 1 else parts[0].clone()

    @staticmethod
    def backward(ctx, gy):
        segs, mine, off, s, e, keep, group, shape, dt = ctx.geom
        n, c, h, w = shape
        acc = _acc_dtype(dt)
        buf = gy.new_zeros((n, c, off, w), dtype=acc)
        at = 0
        if "pre" in mine:
            o, k = mine["pre"]
            buf[:, :, o:o + k] = gy[:, :, :k]
            at = k
        gx = gy.new_zeros((n, c, h, w), dtype=acc)
        nk = keep[1] - keep[0]
        gx[:, :, keep[0]:keep[1]] = gy[:, :, at:at + nk]
        if "post" in mine:
            o, k = mine["post"]
            buf[:, :, o:o + k] = gy[:, :, at + nk:at + nk + k]
        if off:
            dist.all_reduce(buf, group=group)
        for o, g0, g1 in segs:
            i0, i1 = max(g0, s), min(g1, e)
            if i0 < i1:
                gx[:, :, i0 - s:i1 - s] += buf[:, :, o + i0 - g0:o + i1 - g0]
        return gx.to(dt), None, None, None, None, None


def rows(x: torch.Tensor, spans: Sequence[Tuple[int, int]]) -> torch.Tensor:
    """Global rows ``[a, b)`` of the banded map ``x``, where ``spans[r] =
    (a, b)`` for every spatial rank ``r`` (every rank passes the whole
    list, so that each knows what to send); rows within ``[0, H)``.
    Outside a scope: ``x[:, :, a:b]`` of ``spans[0]``."""
    ctx = current()
    if ctx is None:
        a, b = spans[0]
        return x[:, :, a:b]
    starts, stops, _ = band_of(ctx, x.shape[2])
    return _Rows.apply(x, starts, stops, [tuple(v) for v in spans], ctx.me,
                       ctx.group)


def halo(x: torch.Tensor, top: int, bottom: int,
         fill: float = 0.0) -> torch.Tensor:
    """The band ``x`` with ``top`` rows above it and ``bottom`` below from
    the ranks that hold them, ``fill`` beyond the image. Outside a scope
    the map is whole and its halo all ``fill``."""
    ctx = current()
    if ctx is None or (top <= 0 and bottom <= 0):
        return F.pad(x, (0, 0, max(top, 0), max(bottom, 0)), value=fill)
    starts, stops, h = band_of(ctx, x.shape[2])
    spans = [(max(s - top, 0), min(e + bottom, h))
             for s, e in zip(starts, stops)]
    y = rows(x, spans)
    a, b = spans[ctx.me]
    pad_t = top - (starts[ctx.me] - a)
    pad_b = bottom - (b - stops[ctx.me])
    if pad_t or pad_b:
        y = F.pad(y, (0, 0, pad_t, pad_b), value=fill)
    return y


class _SpatialSum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        y = x.to(_acc_dtype(x.dtype), copy=True)
        dist.all_reduce(y, group=group)
        return y.to(x.dtype)

    @staticmethod
    def backward(ctx, g):
        gy = g.to(_acc_dtype(g.dtype), copy=True)
        dist.all_reduce(gy, group=ctx.group)
        return gy.to(g.dtype), None


def spatial_sum(x: torch.Tensor) -> torch.Tensor:
    """``x`` summed over the spatial group, with its gradient; ``x``
    outside a scope."""
    ctx = current()
    if ctx is None:
        return x
    return _SpatialSum.apply(x, ctx.group)


class _Gather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, s, h, group):
        ctx.band, ctx.group = (s, s + x.shape[2]), group
        n, c, _, w = x.shape
        buf = x.new_zeros((n, c, h, w), dtype=_acc_dtype(x.dtype))
        buf[:, :, s:s + x.shape[2]] = x
        dist.all_reduce(buf, group=group)
        return buf.to(x.dtype)

    @staticmethod
    def backward(ctx, g):
        gy = g.to(_acc_dtype(g.dtype), copy=True)
        dist.all_reduce(gy, group=ctx.group)
        s, e = ctx.band
        return gy[:, :, s:e].to(g.dtype), None, None, None


def gather_rows(x: torch.Tensor) -> torch.Tensor:
    """The whole map of the band ``x`` on every spatial rank; ``x``
    outside a scope."""
    ctx = current()
    if ctx is None:
        return x
    starts, _, h = band_of(ctx, x.shape[2])
    return _Gather.apply(x, starts[ctx.me], h, ctx.group)


def _pair(v) -> Tuple[int, int]:
    return (v, v) if isinstance(v, int) else (int(v[0]), int(v[1]))


def conv2d(conv: torch.nn.Conv2d, x: torch.Tensor) -> torch.Tensor:
    """``conv(x)`` of a band: its rows' halo (zero beyond the image), the
    conv with no height padding. The conv must be same-padded (its output
    has ``H / stride`` rows), so that each band's output starts at its
    first row divided by the stride."""
    kh, _ = _pair(conv.kernel_size)
    sh, _ = _pair(conv.stride)
    ph, pw = _pair(conv.padding)
    dh, _ = _pair(conv.dilation)
    ctx = current()
    starts, _, h = band_of(ctx, x.shape[2])
    if (h + 2 * ph - dh * (kh - 1) - 1) // sh + 1 != h // sh or \
            starts[ctx.me] % sh or x.shape[2] % sh:
        raise ValueError(
            f"a conv of kernel {kh}, stride {sh}, padding {ph}, dilation "
            f"{dh} on {h} rows is not same-padded on whole bands; spatial "
            "partitioning takes same-padded convs only")
    top, bottom = ph, dh * (kh - 1) + 1 - sh - ph
    xh = halo(x, top, max(bottom, 0))
    return F.conv2d(xh, conv.weight, conv.bias, conv.stride, (0, pw),
                    conv.dilation, conv.groups)


def max_pool_same(x: torch.Tensor, k: int) -> torch.Tensor:
    """MaxPool2d(k, stride 1, padding k // 2) of a band: a -inf halo of
    k // 2 rows each side."""
    p = k // 2
    return F.max_pool2d(halo(x, p, p, float("-inf")), k, 1, (0, p))
