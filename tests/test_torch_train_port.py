"""desenet_tpu_torch.train.make_train_step alone, on the CPU: a uint8
batch and the same batch as floats in [0, 1] give the same step, the
metrics and counters after one step, the checks that the step makes of its
model and state, and the BNs that never run (their conv's input is 1x1),
which the optimizer must not see."""

import numpy as np
import pytest
import torch

import torch_train_case as C
from desenet_tpu_torch.losses import DetectionLoss
from desenet_tpu_torch.models import build_model, init_weights
from desenet_tpu_torch.testing import train_parity, train_steps
from desenet_tpu_torch.train import create_train_state, make_train_step
from desenet_tpu_torch.train import one_cycle
from desenet_tpu_torch.train.optim import OptimConfig


def port_step(fused=True, **kw):
    model, _ = build_model(C.tiny_cfg(), seg_upsample=not fused, train=True)
    init_weights(model, torch.Generator().manual_seed(0))
    cfg = OptimConfig()
    state = create_train_state(model, cfg)
    step = make_train_step(model, DetectionLoss(anchors=C.ANCHORS, nc=3), cfg,
                           one_cycle(1, 0.2, 10), nb=4, warmup_iters=2,
                           nominal_bs=2, batch_size=2, fused_seg=fused, **kw)
    return model, state, step


def test_uint8_and_float_images_agree():
    b = C.batch()
    out = []
    for img in (b["image"], b["image"].astype(np.float32) / 255.0):
        _, state, step = port_step()
        state, m = step(state, {**b, "image": img})
        out.append((m, {k: v.detach().clone() for k, v in
                        state.params.items()}))
    (m0, p0), (m1, p1) = out
    assert float(m0["loss"]) == float(m1["loss"])
    for k in p0:
        torch.testing.assert_close(p0[k], p1[k], rtol=0, atol=0)


def test_metrics_and_counters():
    _, state, step = port_step()
    state, m = step(state, C.batch())
    assert sorted(m) == ["lbox", "lcls", "lobj", "loss", "lr", "lseg",
                         "stepped"]
    assert all(torch.isfinite(m[k]) and m[k].ndim == 0
               for k in ("lbox", "lcls", "lobj", "loss", "lseg"))
    assert m["stepped"] == 1 and m["lr"] == 0.0  # warmup_t is 0 at ni 0
    assert (state.step, state.last_opt_step, state.ema_updates) == (1, 0, 1)
    assert all(p.grad is None for p in state.params.values())


def test_seg_output_must_match_fused_seg():
    model, _ = build_model(C.tiny_cfg(), seg_upsample=True, train=True)
    with pytest.raises(ValueError, match="seg_upsample"):
        make_train_step(model, DetectionLoss(anchors=C.ANCHORS, nc=3),
                        OptimConfig(), one_cycle(1, 0.2, 10), nb=4,
                        warmup_iters=2, fused_seg=True)
    _, state, step = port_step()
    other, _ = build_model(C.tiny_cfg(), seg_upsample=False, train=True)
    state.model = other
    with pytest.raises(ValueError, match="another model"):
        step(state, C.batch())


def test_never_run_bns_are_not_trained():
    """The BNs after a 1x1 input (PyramidPooling k=1, the ACSP global
    branch) have no JAX variables: the optimizer does not see them and
    they keep their init."""
    model, state, step = port_step()
    quirk = model.quirk_bn_keys()
    assert quirk and not set(quirk) & (set(state.params) | set(state.ema))
    before = {k: v.clone() for k, v in model.state_dict().items()
              if k in quirk}
    step(state, C.batch())
    for k, v in model.state_dict().items():
        if k in quirk:
            assert torch.equal(v, before[k]), k


def test_train_steps_keep_each_step():
    """``testing.train_steps`` (the card's parity check) keeps each step's
    state as it was: its first step equals a one-step run, and the second
    step moved the parameters, also for float64 tensors on the CPU, which
    ``.double().cpu()`` would not copy."""
    two = train_steps("cpu", True, torch.float64, 2)
    one = train_steps("cpu", True, torch.float64, 1)
    assert two[0][0] == one[0][0]
    for g, d in one[0][1].items():
        for k, v in d.items():
            assert torch.equal(two[0][1][g][k], v), (g, k)
    assert any(not torch.equal(two[0][1]["params"][k], v)
               for k, v in two[1][1]["params"].items())
    res = train_parity("cpu", True, torch.float64)
    assert all(e == 0 if g == "loss" else e[0] == 0
               for r in res for g, e in r.items())
