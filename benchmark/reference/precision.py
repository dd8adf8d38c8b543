"""Full float32 for the reference: cuDNN and cuBLAS take float32 convs and
matmuls in TF32 by default on the card."""

from __future__ import annotations

import contextlib

import torch


@contextlib.contextmanager
def no_tf32():
    saved = (torch.backends.cudnn.allow_tf32,
             torch.backends.cuda.matmul.allow_tf32)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        yield
    finally:
        (torch.backends.cudnn.allow_tf32,
         torch.backends.cuda.matmul.allow_tf32) = saved
