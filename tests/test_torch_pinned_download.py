"""How ``Predictor.run_batch`` brings its results back to the host
(``desenet_tpu_torch/api.py``), and ``__call__``'s masks.

On the CPU (tier-1): ``run_batch`` returns what the download by ``.cpu()``
returned, for one replica and for two (a padded batch), and ``__call__``'s
masks own their memory (the counters on the CPU: tests/test_torch_tracing.py).

On the card (marked ``cuda``, skipped without one; decided in the
fixture): every output bit-equal to the download by ``.cpu()`` at b8, for
one replica and two (two cards where there are two, else twice the one
card); every array a view of a pinned tensor; the arrays of one call left
as they were by the next call on another batch; ``Detections`` masks not
pinned; ``download.pinned_bytes`` the outputs' bytes and
``download.pageable_bytes`` 0, with one ``predict.download`` a replica.
Run on the card:

    python -m pytest --noconftest tests/test_torch_pinned_download.py -q
"""

import numpy as np
import pytest
import torch

from desenet_tpu_torch.api import Predictor
from desenet_tpu_torch.models import build_model
from desenet_tpu_torch.parallel.mesh import Mesh, pad_batch_for_mesh
from desenet_tpu_torch.testing import boosted_state, tiny_cfg
from desenet_tpu_torch.utils import profiling

IMGSZ = 64


def _predictor(device, replicas: int, half: bool) -> Predictor:
    cfg = tiny_cfg()
    model, _ = build_model(cfg)
    pred = Predictor(cfg, boosted_state(model, 0), imgsz=IMGSZ,
                     conf_thres=1e-3, half=half, device=device)
    if replicas > 1:
        dev = torch.device(device)
        if dev.type == "cuda":
            n = torch.cuda.device_count()
            devs = [torch.device("cuda", min(i, n - 1))
                    for i in range(replicas)]
        else:
            devs = [dev] * replicas
        pred._place_replicas(devs)
    return pred


def _batch(seed: int, b: int) -> np.ndarray:
    return np.random.default_rng(seed).integers(
        0, 256, (b, IMGSZ, IMGSZ, 3), dtype=np.uint8)


def pageable_run_batch(pred: Predictor, batch: np.ndarray):
    """``run_batch`` with the download it had before: each replica's
    outputs brought back one by one with ``.cpu()``."""
    n, k = len(batch), len(pred._replicas)
    batch = pad_batch_for_mesh({"image": batch}, Mesh(k, 1))[0]["image"]
    parts = []
    for (dev, model), part in zip(pred._replicas, np.split(batch, k)):
        nms, seg = pred.infer(torch.from_numpy(part).to(dev), model)
        parts.append([v.cpu().numpy() for v in (
            nms.boxes, nms.scores, nms.classes, nms.num, seg)])
    return [np.concatenate(v)[:n] for v in zip(*parts)]


def _check_equal(got, want):
    assert len(got) == len(want) == 5
    for g, w in zip(got, want):
        assert g.dtype == w.dtype and g.shape == w.shape
        np.testing.assert_array_equal(g, w)


@pytest.fixture
def tracing():
    profiling.reset()
    profiling.set_tracing(True)
    try:
        yield
    finally:
        profiling.set_tracing(False)
        profiling.reset()


# -- the CPU ---------------------------------------------------------------

@pytest.fixture(scope="module")
def cpu_preds():
    return {k: _predictor("cpu", k, half=False) for k in (1, 2)}


@pytest.mark.parametrize("replicas", [1, 2])
def test_run_batch_returns_what_cpu_download_did(cpu_preds, replicas):
    pred = cpu_preds[replicas]
    batch = _batch(1, 3)  # odd: two replicas take a padded row
    got = pred.run_batch(batch)
    _check_equal(got, pageable_run_batch(pred, batch))
    assert got[3].sum() > 0  # some detections to compare


def test_call_masks_own_their_memory(cpu_preds):
    rng = np.random.default_rng(3)
    # a frame of the network's size (the mask is the seg map's crop, no
    # resize), one letterboxed with pad rows, one resized
    imgs = [rng.integers(0, 256, shape, dtype=np.uint8)
            for shape in ((IMGSZ, IMGSZ, 3), (48, IMGSZ, 3), (96, 80, 3))]
    res = cpu_preds[1](imgs)
    for im, m in zip(imgs, res.masks):
        assert m.shape == im.shape[:2]
        assert m.base is None and m.flags.owndata


# -- the card --------------------------------------------------------------

@pytest.fixture(scope="module")
def card_preds():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return {k: _predictor("cuda", k, half=True) for k in (1, 2)}


def _pinned(a: np.ndarray) -> bool:
    return isinstance(a.base, torch.Tensor) and a.base.is_pinned()


@pytest.mark.cuda
@pytest.mark.parametrize("replicas", [1, 2])
def test_card_download_bit_equal_to_cpu_copies(card_preds, replicas):
    pred = card_preds[replicas]
    batch = _batch(4, 8)
    got = pred.run_batch(batch)
    _check_equal(got, pageable_run_batch(pred, batch))
    assert got[3].sum() > 0
    odd = _batch(5, 7)  # two replicas take a padded row
    _check_equal(pred.run_batch(odd), pageable_run_batch(pred, odd))


@pytest.mark.cuda
@pytest.mark.parametrize("replicas", [1, 2])
def test_card_results_are_pinned_views(card_preds, replicas):
    got = card_preds[replicas].run_batch(_batch(6, 8))
    assert all(_pinned(a) for a in got)


@pytest.mark.cuda
@pytest.mark.parametrize("replicas", [1, 2])
def test_card_results_survive_the_next_call(card_preds, replicas):
    pred = card_preds[replicas]
    first = pred.run_batch(_batch(7, 8))
    kept = [a.copy() for a in first]
    for seed in (8, 9):  # the allocator may hand out freed blocks again
        second = pred.run_batch(_batch(seed, 8))
        assert not np.array_equal(second[1], kept[1])  # other scores
        assert not any(np.shares_memory(a, b)
                       for a, b in zip(first, second))
        del second
    _check_equal(first, kept)


@pytest.mark.cuda
def test_card_call_masks_not_pinned(card_preds):
    rng = np.random.default_rng(10)
    imgs = [rng.integers(0, 256, shape, dtype=np.uint8)
            for shape in ((IMGSZ, IMGSZ, 3), (48, IMGSZ, 3), (96, 80, 3))]
    res = card_preds[1](imgs)
    for m in res.masks:
        assert m.base is None or not _pinned(m)
        assert m.flags.owndata


@pytest.mark.cuda
@pytest.mark.parametrize("replicas", [1, 2])
def test_card_counts_pinned_bytes_and_a_download_a_replica(
        card_preds, replicas, tracing):
    got = card_preds[replicas].run_batch(_batch(11, 8))
    c = profiling.counters()
    assert c["download.pinned_bytes"] == sum(a.nbytes for a in got)
    assert c["download.pageable_bytes"] == 0
    downloads = profiling.spans("predict.download")
    assert sorted(s.attrs["replica"] for s in downloads) == list(
        range(replicas))
    top = profiling.spans("predict.run_batch")
    assert len(top) == 1 and all(s.parent == top[0].id for s in downloads)
