"""Instance masks of a Segment model (YOLOv5 v7.0's ``process_mask`` with
``upsample=False``), bit-packed.

For kept box j of image b, with ``c`` its ``nm`` mask coefficients (the
decode's row at the box's anchor, columns 5 + nc onwards) and ``(x1, y1,
x2, y2)`` its box in input pixels, the mask at proto pixel (y, x) is
``sigmoid(c . P[b, :, y, x]) > 0.5`` (that is ``c . P > 0``) inside the
crop ``x1 * sx <= x < x2 * sx``, ``y1 * sy <= y < y2 * sy`` (v7.0's
``crop_mask`` on the box scaled by the proto's size over the input's,
``sx = Wp / W``), 0 outside it; rows ``j >= num[b]`` are zero. The result
is (B, max_det, Hp, Wp / 8) uint8: bit k of byte i in row y is pixel
x = 8 i + k (numpy ``packbits(..., bitorder="little")``).

On a CUDA tensor ``assemble_masks`` launches ``csrc/mask_assembly.cu``
(``mask_assembly_kernel``; bf16 or f32 prototypes, 32 coefficients a box)
or raises; on a CPU tensor it runs ``assemble_masks_plain``: a float32
matmul, the sigmoid, the crop and the packing in PyTorch ops. The dot
products are float32 on both; their order differs, so a bit may differ
where ``|c . P|`` is a few float32 roundings from 0.

With tracing on (``utils/profiling``), each call counts the images
(``masks.images``) and the boxes assembled (``masks.kept``, summed on the
device) after the launch.
"""

from __future__ import annotations

import torch

from desenet_tpu_torch.ops import _ext
from desenet_tpu_torch.utils import profiling

NM = 32  # mask coefficients a box the kernel takes (v7.0's nm)
launches = 0  # kernel launches made by assemble_masks


def _check(decode, index, boxes, num, proto, nc: int):
    b, max_det = index.shape
    if decode.dim() != 3 or decode.shape[0] != b:
        raise ValueError(f"decode {tuple(decode.shape)} is no (B, A, ncol) "
                         f"of the index's {b} images")
    nm = proto.shape[1]
    if decode.shape[2] < 5 + nc + nm:
        raise ValueError(f"decode of {decode.shape[2]} columns holds no "
                         f"{nm} coefficients after 5 + {nc}")
    if boxes.shape != (b, max_det, 4) or num.shape != (b,):
        raise ValueError(f"boxes {tuple(boxes.shape)} and num "
                         f"{tuple(num.shape)} do not match index "
                         f"{tuple(index.shape)}")
    if proto.dim() != 4 or proto.shape[0] != b or proto.shape[3] % 8:
        raise ValueError(f"proto {tuple(proto.shape)} is no (B, nm, Hp, Wp) "
                         "with Wp a multiple of 8")
    devs = {t.device for t in (decode, index, boxes, num, proto)}
    if len(devs) != 1:
        raise ValueError(f"assemble_masks inputs lie on {sorted(map(str, devs))}")


def assemble_masks_plain(decode, index, boxes, num, proto, nc: int,
                         img_hw) -> torch.Tensor:
    """The masks in PyTorch ops, image by image (module docstring)."""
    _check(decode, index, boxes, num, proto, nc)
    b, max_det = index.shape
    nm, hp, wp = proto.shape[1:]
    sy, sx = hp / img_hw[0], wp / img_hw[1]
    out = torch.zeros((b, max_det, hp, wp // 8), dtype=torch.uint8,
                      device=proto.device)
    r = torch.arange(wp, device=proto.device, dtype=torch.float32)
    c = torch.arange(hp, device=proto.device, dtype=torch.float32)
    weight = (1 << torch.arange(8, device=proto.device)).to(torch.uint8)
    for i in range(b):
        n = min(int(num[i]), max_det)
        if n <= 0:
            continue
        coef = decode[i, index[i, :n].long(), 5 + nc:5 + nc + nm].float()
        m = (coef @ proto[i].float().reshape(nm, -1)).sigmoid()
        m = m.view(n, hp, wp) > 0.5
        box = boxes[i, :n].float()
        x1, y1 = box[:, 0] * sx, box[:, 1] * sy
        x2, y2 = box[:, 2] * sx, box[:, 3] * sy
        keep = ((r[None, None, :] >= x1[:, None, None])
                & (r[None, None, :] < x2[:, None, None])
                & (c[None, :, None] >= y1[:, None, None])
                & (c[None, :, None] < y2[:, None, None]))
        bits = (m & keep).to(torch.uint8).view(n, hp, wp // 8, 8)
        out[i, :n] = (bits * weight).sum(-1, dtype=torch.uint8)
    return out


def assemble_masks(decode, index, boxes, num, proto, nc: int,
                   img_hw) -> torch.Tensor:
    """decode (B, A, 5 + nc + nm) f32, index (B, max_det) int32 (each kept
    box's anchor), boxes (B, max_det, 4) f32 xyxy in input pixels, num (B,)
    int32, proto (B, nm, Hp, Wp), img_hw the input's (H, W) -> (B, max_det,
    Hp, Wp / 8) uint8 bits (module docstring)."""
    global launches
    if proto.device.type == "cpu":
        out = assemble_masks_plain(decode, index, boxes, num, proto, nc,
                                   img_hw)
    elif proto.device.type != "cuda":
        raise ValueError(f"assemble_masks runs on CPU or CUDA, not "
                         f"{proto.device}")
    else:
        _check(decode, index, boxes, num, proto, nc)
        if proto.shape[1] != NM:
            raise ValueError(f"mask_assembly_kernel takes {NM} coefficients "
                             f"a box, not {proto.shape[1]}")
        if proto.dtype not in (torch.bfloat16, torch.float32):
            raise ValueError(f"proto in {proto.dtype}: bfloat16 or float32")
        if decode.dtype != torch.float32 or index.dtype != torch.int32 \
                or num.dtype != torch.int32:
            raise ValueError("assemble_masks needs an f32 decode and int32 "
                             "index and num")
        b, max_det = index.shape
        hp, wp = proto.shape[2:]
        decode, index = decode.contiguous(), index.contiguous()
        boxes, num = boxes.float().contiguous(), num.contiguous()
        nhwc = proto.permute(0, 2, 3, 1).contiguous()  # a view if NHWC
        out = torch.empty((b, max_det, hp, wp // 8), dtype=torch.uint8,
                          device=proto.device)
        stream, dev = _ext.stream_and_device(proto)
        _ext.check(_ext.load().desenet_mask_assembly(
            decode.data_ptr(), decode.shape[1], decode.shape[2], 5 + nc,
            index.data_ptr(), boxes.data_ptr(), num.data_ptr(),
            nhwc.data_ptr(), int(proto.dtype == torch.bfloat16), b, hp, wp,
            max_det, float(wp / img_hw[1]), float(hp / img_hw[0]),
            out.data_ptr(), stream, dev), "mask_assembly kernel")
        launches += 1
    if profiling.tracing():
        profiling.count("masks.images", index.shape[0])
        profiling.count("masks.kept", num.sum())
    return out
