"""Synthetic training batches, made on the device from the seed: the kind
``desenet_tpu_torch.testing.train_batch`` makes (uniform noise images, 1
to ``max_targets`` boxes an image, each painted one colour, and seg labels
of class 1 under every box), vectorized."""

from __future__ import annotations

import torch

PAINT = (200, 30, 30)


def make_batch(b: int, size: int, nc: int, max_targets: int, seed: int,
               device) -> dict:
    g = torch.Generator(device=device)
    g.manual_seed(int(seed) % (1 << 63) ^ 0x7A1B)
    img = torch.randint(0, 256, (b, size, size, 3), generator=g,
                        device=device, dtype=torch.uint8)
    n = torch.randint(1, max_targets + 1, (b,), generator=g, device=device)
    mask = torch.arange(max_targets, device=device)[None] < n[:, None]
    tg = torch.zeros((b, max_targets, 5), device=device)
    tg[..., 0] = torch.randint(0, nc, (b, max_targets), generator=g,
                               device=device).float()
    tg[..., 1:3] = torch.rand((b, max_targets, 2), generator=g,
                              device=device) * 0.7 + 0.15
    tg[..., 3:5] = torch.rand((b, max_targets, 2), generator=g,
                              device=device) * 0.27 + 0.03
    tg[~mask] = 0
    seg = torch.zeros((b, size, size), dtype=torch.uint8, device=device)
    px = torch.arange(size, device=device)
    for i in range(b):  # one image's boxes at a time: (M, size, size)
        cx, cy, w, h = tg[i, :, 1:5].unbind(-1)
        y0 = ((cy - h / 2) * size).long()[:, None]
        y1 = ((cy + h / 2) * size).long()[:, None]
        x0 = ((cx - w / 2) * size).long()[:, None]
        x1 = ((cx + w / 2) * size).long()[:, None]
        rows = (px[None] >= y0) & (px[None] < y1) & mask[i][:, None]
        cols = (px[None] >= x0) & (px[None] < x1)
        box = (rows[:, :, None] & cols[:, None, :]).any(0)
        seg[i][box] = 1
        img[i][box] = torch.tensor(PAINT, dtype=torch.uint8, device=device)
    return {"image": img, "det_targets": tg, "det_mask": mask,
            "seg_labels": seg}
