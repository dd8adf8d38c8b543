"""The SegMaskPSP2 seg head fused for eval, BN folded.

Counterpart of ``desenet_tpu/ops/seg_head_pallas.py``. The host part runs
as tensor ops outside the kernel, as there: the BN fold
(``utils/fold.fold_conv``, eps 1e-3; the two
convs on a 1x1 input, the global branch and pyramid k=1, fold to conv only),
the m16/m32 stems at their native resolution with their 1x1 branch0_a /
context_red slices applied, then the commuted align-corners bilinear
upsample into two summed planes, and the kron'd pool and upsample matrices
of pyramid k=2,3,6 from ``ops/resize.py``'s constructors. The head body is
kernel K4: on a CUDA tensor ``fused_psp2_eval`` launches the kernels of
``csrc/seg_head_psp2.cu`` or raises; on a CPU tensor it runs the body in
PyTorch ops, as ``fused_psp2_eval_plain`` does on any device. In bfloat16
the convs whose widths allow it (``conv_variant``) run on the tensor cores,
and the two 1x1 convs onto few channels on a kernel of their own;
the FFM conv's second input ``ctx`` (4 * (c_hid // 6 // 4) channels, 20 at
c_hid 128) is allocated with its channels padded to a multiple of 16, zeros
in the pad and zero rows in the weights to match (``pad_ffm_weights``),
which changes no sum.

The body (both versions) is the JAX kernel's: f32 accumulation, rounding to
the model dtype where it applies ``act`` or ``.astype(dt)``. Eval only;
``MAX_P8`` bounds the 1/8-resolution positions per image, as in the JAX
package (the model takes the module path above it).
"""

from __future__ import annotations

import functools
import itertools
import weakref

import numpy as np
import torch
import torch.nn.functional as F

from desenet_tpu_torch.ops import _ext
from desenet_tpu_torch.ops.resize import (_adaptive_pool_matrix,
                                          _linear_matrix, resize_bilinear)
from desenet_tpu_torch.utils.fold import fold_conv

launches = 0  # calls of fused_psp2_eval that launched the kernels
# conv launches by kernel, all calls
conv_variants = {"mma": 0, "narrow": 0, "fma": 0}
_VARIANT_CODE = {"fma": 0, "mma": 1, "narrow": 2}
MAX_P8 = 8192
POOL_SIZES = (2, 3, 6)
_CONV_SILU, _CONV_LINEAR_F32 = 0, 1
_SMALL_NONE, _SMALL_SILU, _SMALL_SIGMOID = 0, 1, 2


def _silu_f32(x):
    return x * torch.sigmoid(x)


def _mm(a, w):
    """a @ w with f32 accumulation (inputs are exact in f32)."""
    return torch.matmul(a.float(), w.float())


def fold_head(head) -> dict:
    """The port's ``SegMaskPSP2`` module -> its folded f32 weights."""
    sp = head.spatial_path
    pp = head.context_path[1]
    cba = lambda m: fold_conv(m.conv, m.bn)  # noqa: E731
    f = {
        "m8": cba(head.m8[0]), "m16": cba(head.m16[0]),
        "m32": cba(head.m32[0]),
        "b0a": cba(sp.branch0[0]), "b0b": cba(sp.branch0[1]),
        "b1": fold_conv(sp.branch1[0], sp.branch1[1]),
        "b2": fold_conv(sp.branch2[0], sp.branch2[1]),
        "g": fold_conv(sp.branch_global[1].conv, None),
        "lin": cba(sp.ConvLinear), "red": cba(head.context_path[0]),
        "pp1": fold_conv(pp.conv1.conv, None),
        "pp": [cba(getattr(pp, f"conv{i}")) for i in (2, 3, 4)],
        "cb": cba(head.ffm.convblk),
        "fc1": fold_conv(head.ffm.channel_attention[1], None)[0],
        "fc2": fold_conv(head.ffm.channel_attention[3], None)[0],
        "out": (head.out[0].weight.detach().float()[:, :, 0, 0].t(),
                head.out[0].bias.detach().float()),
    }
    if pp.k != (1, 2, 3, 6) or sp.branch_global is None:
        raise ValueError("fused_psp2_eval needs the shipped SegMaskPSP2 "
                         "(pyramid k = 1, 2, 3, 6 and a global branch)")
    return f


@functools.lru_cache(maxsize=16)
def _kmats(h8: int, w8: int, dtype: torch.dtype, device: torch.device):
    """[(pool (k*k, P8), up (P8, k*k)) for k = 2, 3, 6] in the model dtype,
    plus the (P8, 1) ones that broadcast the k=1 branch."""
    mats = []
    for k in POOL_SIZES:
        pk = np.kron(_adaptive_pool_matrix(h8, k), _adaptive_pool_matrix(w8, k))
        uk = np.kron(_linear_matrix(k, h8, True), _linear_matrix(k, w8, True))
        mats.append((torch.from_numpy(pk).to(device, dtype).contiguous(),
                     torch.from_numpy(uk).to(device, dtype).contiguous()))
    ones = torch.ones((h8 * w8, 1), dtype=dtype, device=device)
    return mats, ones


# head -> {(dtype, device): (state, folded weights)}: the fold is some
# hundred small tensor ops, more host time than the kernels take on the card,
# so it is kept until a parameter or buffer of the head changes
_folded = weakref.WeakKeyDictionary()


def _head_state(head):
    """What the folded weights depend on: every parameter's and buffer's
    storage and version (in-place updates and ``load_state_dict`` bump the
    version, ``.to()`` moves the storage). None, which never matches, for
    a head with inference tensors: they keep no version."""
    tensors = list(itertools.chain(head.parameters(), head.buffers()))
    if any(t.is_inference() for t in tensors):
        return None
    return tuple((t.data_ptr(), t._version) for t in tensors)


def _folded_weights(head, dt: torch.dtype, device: torch.device) -> dict:
    """The head's folded weights for the kernel body: matrices in the model
    dtype, biases in f32, the raw folds under ``"f"``."""
    state = _head_state(head)
    cached = _folded.setdefault(head, {}).get((dt, device))
    if cached is not None and state is not None and cached[0] == state:
        return cached[1]
    f = fold_head(head)
    c_hid = f["m8"][0].shape[-1]
    w0a, wred = f["b0a"][0], f["red"][0]
    c = lambda t: t.to(dt).contiguous()  # noqa: E731
    w = {
        "f": f,
        "m8": c(f["m8"][0]), "bm8": f["m8"][1],
        "w0a8": c(w0a[:c_hid]), "b0a": f["b0a"][1],
        "w0b": c(f["b0b"][0]), "b0b": f["b0b"][1],
        "w1": c(f["b1"][0]), "b1": f["b1"][1],
        "w2": c(f["b2"][0]), "b2": f["b2"][1],
        "wg": c(f["g"][0]), "wlin": c(f["lin"][0]), "blin": f["lin"][1],
        "wred8": c(wred[:c_hid]), "bred": f["red"][1],
        "wpp1": c(f["pp1"][0]),
        "pp": [(c(wk), bk) for wk, bk in f["pp"]],
        "wcb": c(f["cb"][0]), "bcb": f["cb"][1],
        "wfc1": c(f["fc1"]), "wfc2": c(f["fc2"]),
        "wout": c(f["out"][0]), "bout": f["out"][1],
    }
    nctx = 4 * w["wpp1"].shape[-1]
    w["wcb_pad"] = pad_ffm_weights(w["wcb"], c_hid, nctx)
    _folded[head][(dt, device)] = (state, w)
    return w


def _host_part(xs, head):
    """The folded weights (``_folded_weights``) and the m16/m32
    contributions upsampled after their 1x1 slices (asum into branch0_a,
    rsum into context_red)."""
    l16, l19, l22 = xs
    b, h8, w8, _ = l16.shape
    dt = l16.dtype
    w = _folded_weights(head, dt, l16.device)
    f = w["f"]
    c_hid = f["m8"][0].shape[-1]

    def stem_contrib(x, wb):
        g = _mm(x.reshape(b, -1, x.shape[-1]), wb[0].to(dt)) + wb[1]
        return _silu_f32(g).to(dt)  # (B, P_in, c_hid)

    def up(v, src):
        h, w = src.shape[1:3]
        v = v.to(dt).reshape(b, h, w, -1).permute(0, 3, 1, 2)
        v = resize_bilinear(v, (h8, w8), align_corners=True)
        return v.permute(0, 2, 3, 1).reshape(b, h8 * w8, -1)

    g16 = stem_contrib(l19, f["m16"])
    g32 = stem_contrib(l22, f["m32"])
    w0a, wred = f["b0a"][0], f["red"][0]
    sl16, sl32 = slice(c_hid, 2 * c_hid), slice(2 * c_hid, 3 * c_hid)
    asum = (up(_mm(g16, w0a[sl16].to(dt)), l19)
            + up(_mm(g32, w0a[sl32].to(dt)), l22)).to(dt).contiguous()
    rsum = (up(_mm(g16, wred[sl16].to(dt)), l19)
            + up(_mm(g32, wred[sl32].to(dt)), l22)).to(dt).contiguous()

    x8 = l16.reshape(b, h8 * w8, -1).contiguous()
    return x8, asum, rsum, w, _kmats(h8, w8, dt, l16.device)


def _conv3x3_plain(v, w, bias, d, h8, w8, extra=None, w2=None):
    """3x3 conv at dilation d over zero padding as 9 shifted-tap products
    (plus the taps of a second input ``extra`` with weights ``w2``)."""
    b = v.shape[0]
    xp = F.pad(v.reshape(b, h8, w8, -1), (0, 0, d, d, d, d))
    ep = (F.pad(extra.reshape(b, h8, w8, -1), (0, 0, d, d, d, d))
          if extra is not None else None)
    acc = bias.expand(b, h8 * w8, -1)
    for i in range(3):
        for j in range(3):
            tap = xp[:, i * d:i * d + h8, j * d:j * d + w8].reshape(
                b, h8 * w8, -1)
            acc = acc + _mm(tap, w[i, j])
            if ep is not None:
                tape = ep[:, i * d:i * d + h8, j * d:j * d + w8].reshape(
                    b, h8 * w8, -1)
                acc = acc + _mm(tape, w2[i, j])
    return acc


def _body_plain(x8, asum, rsum, w, kmats, h8, w8):
    """The JAX kernel body in PyTorch ops, batched: -> (B, P8, n) f32."""
    dt = x8.dtype
    mats, _ = kmats
    inner = w["w0b"].shape[-1]
    c_hid = w["m8"].shape[-1]
    p8 = h8 * w8

    def act(acc):
        return _silu_f32(acc).to(dt)

    f8 = act(_mm(x8, w["m8"]) + w["bm8"])
    # ACSP spatial path
    x0a = act(_mm(f8, w["w0a8"]) + asum.float() + w["b0a"])
    x0 = act(_conv3x3_plain(x0a, w["w0b"], w["b0b"], 1, h8, w8))
    x1 = act(_conv3x3_plain(x0, w["w1"], w["b1"], 2, h8, w8))
    x2 = act(_conv3x3_plain(x1, w["w2"], w["b2"], 3, h8, w8))
    gm = x2.float().mean(1, keepdim=True).to(dt)
    gv = _silu_f32(_mm(gm, w["wg"])).to(dt)  # BN skipped (1x1 quirk)
    wlin = w["wlin"]
    spatial = act(_mm(x0, wlin[0:inner]) + _mm(x1, wlin[inner:2 * inner])
                  + _mm(x2, wlin[2 * inner:3 * inner])
                  + _mm(gv, wlin[3 * inner:4 * inner]) + w["blin"])
    # context path: red -> pyramid pooling k = 1, 2, 3, 6
    red = act(_mm(f8, w["wred8"]) + rsum.float() + w["bred"])
    pooled1 = red.float().mean(1, keepdim=True).to(dt)
    c1 = _silu_f32(_mm(pooled1, w["wpp1"])).to(dt)  # BN skipped
    branches = [c1.expand(-1, p8, -1)]
    for (pk, uk), (wk, bk) in zip(mats, w["pp"]):
        pooled = _mm(pk, red).to(dt)  # (B, k*k, n_red)
        ck = act(_mm(pooled, wk) + bk)
        branches.append(_mm(uk, ck).to(dt))
    ctx = torch.cat(branches, -1)
    # FFM: 3x3 over [spatial | ctx] + channel attention
    wcb = w["wcb"]
    nctx = ctx.shape[-1]
    feat = act(_conv3x3_plain(spatial, wcb[:, :, 0:c_hid], w["bcb"], 1, h8,
                              w8, extra=ctx,
                              w2=wcb[:, :, c_hid:c_hid + nctx]))
    m = feat.float().mean(1, keepdim=True).to(dt)
    a1 = _silu_f32(_mm(m, w["wfc1"])).to(dt)
    gate = torch.sigmoid(_mm(a1, w["wfc2"])).to(dt)
    out_feat = feat * gate + feat
    return _mm(out_feat, w["wout"]) + w["bout"]


def conv_variant(dtype: torch.dtype, c1: int, c2: int, o: int, lds=(),
                 out_ld: int = 0, taps: int = 1) -> str:
    """The kernel a conv launch takes: ``"mma"`` (tensor cores) in bfloat16
    with O a multiple of 64, both inputs' channels multiples of 16, input
    row pitches ``lds`` multiples of 8 elements and an even output pitch;
    ``"narrow"`` (a thread per pixel) for a 1x1 conv of one input onto at
    most 32 channels, its channels and pitch multiples of 8; else ``"fma"``
    (the CUDA-core tile)."""
    if dtype == torch.bfloat16 and not (
            o % 64 or c1 % 16 or c2 % 16 or out_ld % 2
            or any(ld % 8 for ld in lds)):
        return "mma"
    if taps == 1 and c2 == 0 and o <= 32 and c1 <= 384 and not (
            c1 % 8 or any(ld % 8 for ld in lds)):
        return "narrow"
    return "fma"


def pad_ffm_weights(wcb: torch.Tensor, c_hid: int, nctx: int) -> torch.Tensor:
    """The FFM conv's (3, 3, c_hid + nctx [+ unused], c_hid) weights as the
    ((c_hid + nctx_pad) * 9, c_hid) matrix over [spatial | ctx padded with
    zero channels to a multiple of 16]: zero rows under the pad."""
    pad = -nctx % 16
    wcb = wcb[:, :, 0:c_hid + nctx]
    return F.pad(wcb, (0, 0, 0, pad)).reshape(-1, c_hid).contiguous()


def _conv(lib, b, h8, w8, src, wmat, bias, out, taps=1, dil=1, src2=None,
          rowbias=None, add=None, mode=_CONV_SILU):
    """One launch of desenet_psp2_conv on (B, P8, C) buffers (channel slices
    allowed: the row pitch is passed)."""
    stream, dev = _ext.stream_and_device(src)
    c2 = src2.shape[2] if src2 is not None else 0
    lds = (src.stride(1),) + ((src2.stride(1),) if src2 is not None else ())
    aligned = all(t.data_ptr() % 16 == 0 for t in (src, wmat, out)) and (
        src2 is None or src2.data_ptr() % 16 == 0)
    variant = conv_variant(src.dtype, src.shape[2], c2, out.shape[2], lds,
                           out.stride(1), taps) if aligned else "fma"
    _ext.check(lib.desenet_psp2_conv(
        src.data_ptr(), src.stride(1), src.shape[2],
        src2.data_ptr() if src2 is not None else None,
        src2.stride(1) if src2 is not None else 0, c2,
        wmat.data_ptr(), bias.data_ptr(),
        rowbias.data_ptr() if rowbias is not None else None,
        add.data_ptr() if add is not None else None,
        add.stride(1) if add is not None else 0,
        out.data_ptr(), out.stride(1), b, h8, w8, taps, dil,
        out.shape[2], mode, _VARIANT_CODE[variant],
        int(src.dtype == torch.bfloat16), stream, dev),
        f"seg_head_psp2 conv ({variant})")
    conv_variants[variant] += 1


def conv1x1_f32(a: torch.Tensor, wmat: torch.Tensor) -> torch.Tensor:
    """(M, K) @ (K, N) -> (M, N) f32 as one 1x1 stage of the conv kernel
    (zero bias, no SiLU) on CUDA tensors: the shared tensor-core tile alone
    in bfloat16 with K a multiple of 16 and N of 64, for holding it against
    ``torch.matmul``."""
    if a.device.type != "cuda" or a.dim() != 2 or wmat.dim() != 2 or \
            a.shape[1] != wmat.shape[0] or a.dtype != wmat.dtype:
        raise ValueError("conv1x1_f32 needs CUDA (M, K) and (K, N) tensors "
                         "of one dtype")
    m, n = a.shape[0], wmat.shape[1]
    a, wmat = a.contiguous(), wmat.contiguous()
    out = torch.empty((1, m, n), dtype=torch.float32, device=a.device)
    bias = torch.zeros(n, dtype=torch.float32, device=a.device)
    _conv(_ext.load(), 1, 1, m, a[None], wmat, bias, out,
          mode=_CONV_LINEAR_F32)
    return out[0]


def _body_kernel(x8, asum, rsum, w, kmats, h8, w8):
    """The same body as the kernels of csrc/seg_head_psp2.cu, intermediates
    in (B, P8, C) buffers on the card."""
    lib = _ext.load()
    stream, dev = _ext.stream_and_device(x8)
    dt = x8.dtype
    bf = int(dt == torch.bfloat16)
    mats, ones = kmats
    b, p8, c16 = x8.shape
    inner = w["w0b"].shape[-1]
    c_hid = w["m8"].shape[-1]
    n_red = w["wred8"].shape[-1]
    n4 = w["wpp1"].shape[-1]
    nctx = 4 * n4
    n_out = w["wout"].shape[-1]

    def buf(c, dtype=dt):
        return torch.empty((b, p8, c), dtype=dtype, device=x8.device)

    def vec(*shape):
        return torch.empty(shape, dtype=torch.float32, device=x8.device)

    def conv(src, wmat, bias, out, **kw):
        _conv(lib, b, h8, w8, src, wmat, bias, out, **kw)

    def reduce(src, out, weights=None, kk=1):
        _ext.check(lib.desenet_psp2_reduce(
            src.data_ptr(), src.stride(1), src.shape[2], p8,
            weights.data_ptr() if weights is not None else None, kk, b,
            out.data_ptr(), bf, stream, dev), "seg_head_psp2 reduce")
        return out

    def small(src, n, wmat, out, bias=None, mode=_SMALL_SILU):
        _ext.check(lib.desenet_psp2_small(
            src.data_ptr(), n, wmat.shape[0], wmat.data_ptr(),
            bias.data_ptr() if bias is not None else None, wmat.shape[1],
            mode, bf, out.data_ptr(), stream, dev), "seg_head_psp2 small")
        return out

    def unpool(up, ck, out):
        _ext.check(lib.desenet_psp2_unpool(
            up.data_ptr(), ck.data_ptr(), out.shape[2], p8, up.shape[1], b,
            out.data_ptr(), out.stride(1), bf, stream, dev),
            "seg_head_psp2 unpool")

    f8 = buf(c_hid)
    conv(x8, w["m8"], w["bm8"], f8)
    # ACSP spatial path: x0 | x1 | x2 side by side, read as one input below
    x0a = buf(inner)
    conv(f8, w["w0a8"], w["b0a"], x0a, add=asum)
    x012 = buf(3 * inner)
    x0, x1, x2 = (x012[..., i * inner:(i + 1) * inner] for i in range(3))
    conv(x0a, w["w0b"].reshape(-1, inner), w["b0b"], x0, taps=3, dil=1)
    conv(x0, w["w1"].reshape(-1, inner), w["b1"], x1, taps=3, dil=2)
    conv(x1, w["w2"].reshape(-1, inner), w["b2"], x2, taps=3, dil=3)
    gm = reduce(x2, vec(b, inner))
    gv = small(gm, b, w["wg"], vec(b, inner))
    wlin = w["wlin"]
    gvl = small(gv, b, wlin[3 * inner:4 * inner], vec(b, c_hid),
                mode=_SMALL_NONE)
    spatial = buf(c_hid)
    conv(x012, wlin[0:3 * inner], w["blin"], spatial, rowbias=gvl)
    # context path
    red = buf(n_red)
    conv(f8, w["wred8"], w["bred"], red, add=rsum)
    # ctx's channels padded to a multiple of 16 for the FFM conv, zeros in
    # the pad
    ctx = buf(nctx + -nctx % 16)
    ctx[..., nctx:].zero_()
    pooled1 = reduce(red, vec(b, n_red))
    c1 = small(pooled1, b, w["wpp1"], vec(b, 1, n4))
    unpool(ones, c1, ctx[..., 0:n4])
    for i, ((pk, uk), (wk, bk)) in enumerate(zip(mats, w["pp"])):
        kk = pk.shape[0]
        pooled = reduce(red, vec(b, kk, n_red), weights=pk, kk=kk)
        ck = small(pooled, b * kk, wk, vec(b, kk, n4), bias=bk)
        unpool(uk, ck, ctx[..., (i + 1) * n4:(i + 2) * n4])
    # FFM
    feat = buf(c_hid)
    conv(spatial, w["wcb_pad"], w["bcb"], feat, taps=3, dil=1, src2=ctx)
    m = reduce(feat, vec(b, c_hid))
    a1 = small(m, b, w["wfc1"], vec(b, c_hid))
    gate = small(a1, b, w["wfc2"], vec(b, c_hid), mode=_SMALL_SIGMOID)
    _ext.check(lib.desenet_psp2_gate(feat.data_ptr(), gate.data_ptr(), c_hid,
                                     p8, b, bf, stream, dev),
               "seg_head_psp2 gate")
    logits = buf(n_out, torch.float32)
    conv(feat, w["wout"], w["bout"], logits, mode=_CONV_LINEAR_F32)
    return logits


def _check_inputs(xs):
    if len(xs) != 3 or any(x.dim() != 4 for x in xs):
        raise ValueError("fused_psp2_eval needs [l16, l19, l22] NHWC maps")
    l16 = xs[0]
    if l16.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"fused_psp2_eval runs float32 or bfloat16, not "
                        f"{l16.dtype}")
    if any(x.device != l16.device or x.dtype != l16.dtype for x in xs):
        raise ValueError("fused_psp2_eval inputs differ in device or dtype")
    if l16.shape[1] * l16.shape[2] > MAX_P8:
        raise ValueError(f"{l16.shape[1]}x{l16.shape[2]} positions exceed "
                         f"MAX_P8 = {MAX_P8}")


def fused_psp2_eval_plain(xs, head, n_segcls: int) -> torch.Tensor:
    """``fused_psp2_eval`` in PyTorch ops on any device."""
    _check_inputs(xs)
    b, h8, w8, _ = xs[0].shape
    x8, asum, rsum, w, kmats = _host_part(xs, head)
    out = _body_plain(x8, asum, rsum, w, kmats, h8, w8)
    return out.reshape(b, h8, w8, n_segcls)


@torch.no_grad()
def fused_psp2_eval(xs, head, n_segcls: int) -> torch.Tensor:
    """Eval-only fused SegMaskPSP2 forward.

    xs: [l16 (B, H8, W8, c_hid), l19 (B, H16, W16, 2 c_hid),
    l22 (B, H32, W32, 4 c_hid)] NHWC in the model dtype; head: the port's
    ``SegMaskPSP2`` module (its weights are folded here). Returns the
    (B, H8, W8, n_segcls) f32 logits at 1/8 resolution."""
    global launches
    _check_inputs(xs)
    dev = xs[0].device
    if dev.type == "cpu":
        return fused_psp2_eval_plain(xs, head, n_segcls)
    if dev.type != "cuda":
        raise ValueError(f"fused_psp2_eval runs on CPU or CUDA, not {dev}")
    b, h8, w8, _ = xs[0].shape
    x8, asum, rsum, w, kmats = _host_part(xs, head)
    out = _body_kernel(x8, asum, rsum, w, kmats, h8, w8)
    launches += 1
    return out.reshape(b, h8, w8, n_segcls)
