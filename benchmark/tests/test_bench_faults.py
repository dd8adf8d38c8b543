"""Whole runs on the CPU at a tiny size (the look for a card skipped),
with the timed path sound, with the control in the program's place, and
broken underneath: ``correct`` must come out true only for the first.

The limits are the cells' own (``benchmark/workloads/*.json``). The
served cells' control is the program's fp8 activation storage, the
training cell's the reference with every block's output in fp8
(``control.py``). The faults are those each cell can have: for serving an
answer altered where it is produced (a box in NMS, the seg class map in
the seg tail) and half of the batch left out; for training a step that
leaves the state unchanged and half of the batch left out (the mean over
the rest)."""

import time

import pytest
import torch

import desenet_tpu_torch.api as api
from benchmark import run as R

CELLS = ["s.serve.b128", "s.online.vga"]


def _run(cell, trace=False):
    return R.execute(cell, 2147483663, 1.5, trace, torch.device("cpu"),
                     time.perf_counter())


@pytest.mark.parametrize("cell", CELLS)
def test_sound_run_is_correct(tiny, cell):
    res = _run(cell)
    assert res["correct"], res["checks"]
    assert res["failed"] == 0 and res["attempted"] > 0
    assert list(res)[-1] == "checks"


def test_traced_run_is_correct(tiny):
    res = _run("s.serve.b128", trace=True)
    assert res["correct"], res["checks"]
    assert res["device"]["window_s"] > 0


@pytest.mark.parametrize("cell", CELLS)
def test_control_fails(tiny, monkeypatch, cell):
    build = api.build_model

    def fp8(cfg, **kw):
        return build(cfg, act_store="fp8", **kw)

    monkeypatch.setattr(api, "build_model", fp8)
    assert not _run(cell)["correct"]


def _moved_boxes(monkeypatch):
    nms = api.non_max_suppression

    def moved(*a, **kw):
        out = nms(*a, **kw)
        out.boxes[:, :, 0::2] += 12.0 * out.valid[..., None]
        return out

    monkeypatch.setattr(api, "non_max_suppression", moved)


def _flipped_seg(monkeypatch):
    tail = api.upsample_argmax

    def flipped(*a, **kw):
        return (tail(*a, **kw) + 1) % 3

    monkeypatch.setattr(api, "upsample_argmax", flipped)


def _half_batch(monkeypatch):
    """The program computes the first half of each batch (rounded down:
    a batch of one is left out whole) and leaves the rest zero."""
    infer = api.Predictor.infer

    def half(self, img, model=None):
        nms, seg = infer(self, img, model)
        keep = img.shape[0] // 2
        return (type(nms)(*(torch.cat([t[:keep], torch.zeros_like(t[keep:])])
                            for t in nms)),
                torch.cat([seg[:keep], torch.zeros_like(seg[keep:])]))

    monkeypatch.setattr(api.Predictor, "infer", half)


@pytest.mark.parametrize("cell", CELLS)
@pytest.mark.parametrize("fault", [_moved_boxes, _flipped_seg, _half_batch],
                         ids=["moved_boxes", "flipped_seg", "half_batch"])
def test_fault_fails(tiny, monkeypatch, cell, fault):
    fault(monkeypatch)
    res = _run(cell)
    assert not res["correct"], res["checks"]


TRAIN = "s.train.b64"


def test_train_sound_run_is_correct(tiny):
    res = _run(TRAIN)
    assert res["correct"], res["checks"]


def test_train_control_fails(tiny):
    from benchmark import control

    wl = tiny.workload(TRAIN)
    r = control.train_readings(wl, tiny.config(wl["config"]), 2147483667,
                               torch.device("cpu"))
    assert any(r["control"][k] > v for k, v in wl["limits"].items()), r


def test_train_unchanged_state_fails(tiny, monkeypatch):
    from desenet_tpu_torch.train import optim

    monkeypatch.setattr(optim, "apply_updates", lambda *a, **k: a[2])
    assert not _run(TRAIN)["correct"]


def test_train_half_batch_fails(tiny, monkeypatch):
    from desenet_tpu_torch.train import step as S

    make = S.make_train_step

    def halved(*a, **kw):
        inner = make(*a, **kw)

        def run(state, batch, generator=None):
            n = len(batch["image"]) // 2
            return inner(state, {k: v[:n] for k, v in batch.items()},
                         generator)
        return run

    monkeypatch.setattr(S, "make_train_step", halved)
    import desenet_tpu_torch.train as T

    monkeypatch.setattr(T, "make_train_step", halved)
    assert not _run(TRAIN)["correct"]
