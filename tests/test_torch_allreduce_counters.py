"""The all-reduce counters of ``parallel/multihost.py`` on the gloo path:
two CPU processes (``multihost.spawn``) take a training step of the tiny
model untraced, then one traced.

Untraced, nothing is counted. Traced, ``dist.allreduce.calls`` and
``dist.allreduce.bytes`` hold every all-reduce of the step, counted by
hand: each BatchNorm that ran, forward (its [count, sums, sums of squares]
over the global batch) and backward; the detection loss's batch size and
each level's valid-candidate count; the seg loss's pixel count; the step's
five losses; and one sum of every gradient the optimizer takes (f32).
"""

import numpy as np
import torch

from desenet_tpu_torch.models import build_model
from desenet_tpu_torch.models.layers import BatchNorm2d
from desenet_tpu_torch.parallel import multihost
from desenet_tpu_torch.testing import tiny_cfg, train_batch
from desenet_tpu_torch.train import create_train_state, make_train_step
from desenet_tpu_torch.train.engine import load_hyp, loss_and_schedule
from desenet_tpu_torch.utils import profiling

NPROC, B_GLOBAL, IMGSZ = 2, 4, 64


def _rank(rank: int, nproc: int, coordinator: str) -> dict:
    torch.set_num_threads(1)
    multihost.init_multihost(coordinator, nproc, rank, device="cpu")
    cfg = tiny_cfg()
    torch.manual_seed(0)
    model, spec = build_model(cfg, seg_upsample=False, train=True)
    bn = []  # the channel count of each BatchNorm call

    def seen(mod, inp, out):
        bn.append(mod.num_features)

    for m in model.modules():
        if isinstance(m, BatchNorm2d):
            m.register_forward_hook(seen)
    det_loss, opt_cfg, lf = loss_and_schedule(load_hyp(), spec, IMGSZ, 3)
    state = create_train_state(model, opt_cfg)
    step = make_train_step(model, det_loss, opt_cfg, lf, nb=4,
                           warmup_iters=4, nominal_bs=B_GLOBAL,
                           batch_size=B_GLOBAL, fused_seg=True)
    rows = multihost.local_batch_slice(B_GLOBAL)
    batch = {k: torch.from_numpy(v[rows]) for k, v in train_batch(
        np.random.default_rng(0), B_GLOBAL, IMGSZ, cfg["de_nc"], 4).items()}
    profiling.reset()
    state, _ = step(state, batch)
    off = profiling.counters()
    bn.clear()
    profiling.set_tracing(True)
    try:
        state, _ = step(state, batch)
    finally:
        profiling.set_tracing(False)
    on = profiling.counters()
    quirk = set(model.quirk_bn_keys())
    grads = sum(p.numel() for k, p in state.params.items() if k not in quirk)
    multihost.sync_hosts("done")
    multihost.shutdown()
    return {"off": off, "on": on, "bn": list(bn),
            "nl": len(spec.det_strides), "grads": grads}


def test_allreduce_counters_count_a_traced_step():
    got = multihost.spawn(_rank, NPROC)
    assert got["off"] == {}
    nl, bn = got["nl"], got["bn"]
    assert len(bn) > 10
    calls = 2 * len(bn) + (1 + nl) + 1 + 1 + 1
    nbytes = 4 * (2 * sum(2 * c + 1 for c in bn) + (1 + nl) + 1 + 5
                  + got["grads"])
    assert got["on"] == {"dist.allreduce.calls": calls,
                         "dist.allreduce.bytes": nbytes}
