"""The validation path's NMS, JAX vs port, on the CPU.

(a) ``greedy_nms_plain`` (what the port's K3 wrapper runs on a CPU tensor)
    against the JAX ``greedy_nms_pallas`` in interpret mode: identical
    keep indices and scores (both run the same f32 formula in the same
    order).
(b) The port's ``non_max_suppression`` on the top-k + K3 route (multi-label,
    ``classes``, ``agnostic``, lists of per-scale decodes) against the JAX
    function with ``backend="xla"``: equal counts and classes, scores at
    1e-6, boxes at atol 1e-3 (the XLA loop's IoU adds 1e-7 where the kernel
    adds 1e-9; neither flips a pick on these scenes).
(c) Tied scores: the top-k set and the picks among equal scores follow
    ascending flat index, as ``jax.lax.top_k`` orders them.
(d) ``greedy_nms_ordered_plain``, the plain form of the walk the port's K3
    takes on the card for sorted sets (rounds of candidates against the
    kept list, the survivors' cover mask, its scan in order), against
    ``greedy_nms_plain`` and the JAX kernel in interpret mode: identical
    keep indices and scores on sorted sets with ties, duplicate boxes, no
    live candidate, fewer live than ``max_det`` and a live count on and off
    the round and survivor boundaries, and as a ``hypothesis`` property
    over small sets; ``scores_ordered`` is the kernel's test for that path.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from desenet_tpu.ops import nms as jax_nms
from desenet_tpu.ops.nms_pallas import greedy_nms_pallas as jax_greedy
from desenet_tpu_torch.ops import nms_pallas
from desenet_tpu_torch.ops.nms import (PRE_TOPK_VAL, _prep_candidates,
                                       batched_nms, non_max_suppression)
from desenet_tpu_torch.testing import (dense_sorted_candidates,
                                       greedy_candidates, sorted_candidates)


def make_pred(rng, b=2, a=480, nc=6, obj_lo=0.0):
    """Synthetic (B, A, 5+nc) decode with clustered boxes so NMS matters."""
    centers = rng.uniform(40, 600, (b, a, 2))
    centers[:, a // 2:] = centers[:, :a // 2] + rng.normal(0, 4,
                                                           (b, a // 2, 2))
    wh = rng.uniform(10, 90, (b, a, 2))
    obj = rng.uniform(obj_lo, 1, (b, a, 1))
    cls = rng.uniform(0, 1, (b, a, nc))
    return np.concatenate([centers, wh, obj, cls], -1).astype(np.float32)


def candidates(rng, b=4, k=256):
    centers = rng.uniform(50, 2000, (b, k, 2)).astype(np.float32)
    wh = rng.uniform(20, 150, (b, k, 2)).astype(np.float32)
    boxes = np.concatenate([centers - wh / 2, centers + wh / 2], -1)
    scores = rng.uniform(0, 1, (b, k)).astype(np.float32)
    scores[scores < 0.4] = -1.0
    return boxes, scores


@pytest.mark.parametrize("seed,max_det", [(0, 64), (1, 300)])
def test_greedy_plain_matches_pallas_interpret(seed, max_det):
    boxes, scores = candidates(np.random.default_rng(seed))
    j_idx, j_sc = jax_greedy(jnp.asarray(boxes), jnp.asarray(scores), 0.45,
                             max_det, interpret=True)
    before = nms_pallas.launches
    idx, sc = nms_pallas.greedy_nms_pallas(torch.from_numpy(boxes),
                                           torch.from_numpy(scores), 0.45,
                                           max_det)
    assert nms_pallas.launches == before  # CPU tensors: the plain version
    assert idx.dtype == torch.int32 and idx.shape == (4, max_det)
    np.testing.assert_array_equal(idx.numpy(), np.asarray(j_idx))
    np.testing.assert_array_equal(sc.numpy(), np.asarray(j_sc))
    assert (sc > 0).sum() > 0


def test_greedy_empty_and_single():
    boxes = np.zeros((2, 64, 4), np.float32)
    boxes[..., 2:] = 10
    scores = np.full((2, 64), -1.0, np.float32)
    scores[1, 5] = 0.9
    idx, sc = nms_pallas.greedy_nms_pallas(torch.from_numpy(boxes),
                                           torch.from_numpy(scores), 0.45, 16)
    j_idx, j_sc = jax_greedy(jnp.asarray(boxes), jnp.asarray(scores), 0.45,
                             16, interpret=True)
    np.testing.assert_array_equal(idx.numpy(), np.asarray(j_idx))
    np.testing.assert_array_equal(sc.numpy(), np.asarray(j_sc))
    assert (sc[0] > 0).sum() == 0 and (sc[1] > 0).sum() == 1
    assert int(idx[1, 0]) == 5 and torch.all(idx[:, 1:] == 0)
    assert torch.all(sc[1, 1:] == -1)


def test_greedy_checks_its_inputs():
    boxes, scores = (torch.from_numpy(a) for a in
                     candidates(np.random.default_rng(2), b=2, k=16))
    with pytest.raises(ValueError, match=r"\(B, K, 4\)"):
        nms_pallas.greedy_nms_pallas(boxes[..., :3], scores, 0.45, 8)
    with pytest.raises(ValueError, match="at least one"):
        nms_pallas.greedy_nms_pallas(boxes[:, :0], scores[:, :0], 0.45, 8)
    with pytest.raises(ValueError, match="CPU or CUDA"):
        nms_pallas.greedy_nms_pallas(boxes.to("meta"), scores.to("meta"),
                                     0.45, 8)


def assert_matches_jax(pred, split=None, **kw):
    """Port vs JAX (XLA backend) on the same decode, optionally as a list of
    per-scale chunks split at the given anchor offsets."""
    jin = jnp.asarray(pred)
    tin = torch.from_numpy(pred)
    if split is not None:
        jin = list(jnp.split(jin, split, axis=1))
        tin = list(torch.tensor_split(tin, split, dim=1))
    want = jax_nms.non_max_suppression(jin, backend="xla", **kw)
    got = non_max_suppression(tin, **kw)
    np.testing.assert_array_equal(got.num.numpy(), np.asarray(want.num))
    np.testing.assert_array_equal(got.valid.numpy(), np.asarray(want.valid))
    np.testing.assert_array_equal(got.classes.numpy(),
                                  np.asarray(want.classes))
    np.testing.assert_allclose(got.scores.numpy(), np.asarray(want.scores),
                               rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(got.boxes.numpy(), np.asarray(want.boxes),
                               rtol=1e-5, atol=1e-3)
    return got


VAL = dict(conf_thres=0.001, iou_thres=0.6, max_det=100, multi_label=True)


@pytest.mark.parametrize("case", [
    dict(VAL),
    dict(VAL, pre_topk=512),  # the top-k truncates the candidate set
    dict(VAL, classes=(1, 4)),
    dict(VAL, agnostic=True),
    dict(conf_thres=0.3, iou_thres=0.45, max_det=50, multi_label=True),
    dict(conf_thres=0.25, iou_thres=0.45, max_det=50),  # K1 route
])
def test_multi_label_matches_jax(case):
    pred = make_pred(np.random.default_rng(3))
    out = assert_matches_jax(pred, **case)
    assert int(out.num.min()) > 0
    if "classes" in case:
        assert set(np.unique(out.classes.numpy()[out.valid.numpy()])) <= {
            1.0, 4.0}


@pytest.mark.parametrize("case", [dict(VAL), dict(VAL, pre_topk=300),
                                  dict(conf_thres=0.25, iou_thres=0.45,
                                       max_det=50)])
def test_per_scale_lists_match_jax(case):
    pred = make_pred(np.random.default_rng(4))
    out = assert_matches_jax(pred, split=[240, 420], **case)
    assert int(out.num.min()) > 0


def test_per_scale_list_equals_one_array():
    """The merge of per-scale top sets is exact: a list gives the picks of
    the concatenated decode."""
    pred = torch.from_numpy(make_pred(np.random.default_rng(5)))
    kw = dict(VAL, pre_topk=PRE_TOPK_VAL)
    one = non_max_suppression(pred, **kw)
    parts = non_max_suppression(list(torch.tensor_split(pred, [100, 300], 1)),
                                **kw)
    for a, b in zip(one, parts):
        assert torch.equal(a, b)


def test_tied_scores_follow_flat_index():
    """Every (anchor, class) pair scores exactly 0.5 and no boxes overlap:
    the top-k set and the pick order are the lowest flat indices, so the
    kept pairs are anchors 0.. in order, every class of each."""
    a, nc = 64, 3
    pred = np.zeros((1, a, 5 + nc), np.float32)
    pred[0, :, 0] = 20 + 30 * (np.arange(a) % 8)
    pred[0, :, 1] = 20 + 30 * (np.arange(a) // 8)
    pred[0, :, 2:4] = 10.0
    pred[0, :, 4] = 1.0
    pred[0, :, 5:] = 0.5
    kw = dict(conf_thres=0.1, iou_thres=0.5, max_det=20, multi_label=True,
              pre_topk=40)
    out = assert_matches_jax(pred, **kw)
    assert int(out.num[0]) == 20
    # flat index f = anchor * nc + class, picked in ascending order
    flat = np.arange(20)
    np.testing.assert_array_equal(out.classes[0].numpy(), flat % nc)
    want_x1 = pred[0, flat // nc, 0] - 5.0
    np.testing.assert_array_equal(out.boxes[0, :, 0].numpy(), want_x1)


def test_batched_nms_matches_jax():
    boxes, scores = candidates(np.random.default_rng(6), b=1, k=200)
    cls = np.random.default_rng(7).integers(0, 3, 200).astype(np.float32)
    for agnostic in (False, True):
        j_idx, j_ok = jax_nms.batched_nms(
            jnp.asarray(boxes[0]), jnp.asarray(scores[0]), jnp.asarray(cls),
            0.45, 50, agnostic)
        idx, ok = batched_nms(torch.from_numpy(boxes[0]),
                              torch.from_numpy(scores[0]),
                              torch.from_numpy(cls), 0.45, 50, agnostic)
        np.testing.assert_array_equal(ok.numpy(), np.asarray(j_ok))
        np.testing.assert_array_equal(idx.numpy()[ok.numpy()],
                                      np.asarray(j_idx)[np.asarray(j_ok)])


def test_jax_xla_and_pallas_backends_agree_here():
    """The oracle of (b) is the XLA loop; on these scenes its keep-set is
    the Pallas kernel's, so (b) holds the port to K3's semantics."""
    pred = make_pred(np.random.default_rng(3))
    per_image = functools.partial(jax_nms._prep_candidates, conf_thres=0.001,
                                  pre_topk=1024, multi_label=True, nc=6)
    boxes, scores, cls = jax.vmap(per_image)(jnp.asarray(pred))
    nboxes = boxes + cls[..., None] * jax_nms.MAX_WH
    p_idx, p_sc = jax_greedy(nboxes, scores, 0.6, 100, interpret=True)
    x_idx, x_ok = jax.vmap(functools.partial(
        jax_nms._greedy_nms, iou_thres=0.6, max_det=100))(nboxes, scores)
    ok = np.asarray(p_sc) > 0
    np.testing.assert_array_equal(ok, np.asarray(x_ok))
    np.testing.assert_array_equal(np.asarray(p_idx)[ok],
                                  np.asarray(x_idx)[ok])


def assert_walk_matches(boxes, scores, iou, max_det, chunk, surv):
    """The ordered walk == the argmax loop == the JAX kernel (interpret)."""
    want = nms_pallas.greedy_nms_plain(boxes, scores, iou, max_det)
    got = nms_pallas.greedy_nms_ordered_plain(boxes, scores, iou, max_det,
                                              chunk, surv)
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    j_idx, j_sc = jax_greedy(jnp.asarray(boxes.numpy()),
                             jnp.asarray(scores.numpy()), iou, max_det,
                             interpret=True)
    np.testing.assert_array_equal(got[0].numpy(), np.asarray(j_idx))
    np.testing.assert_array_equal(got[1].numpy(), np.asarray(j_sc))
    return got


# (live, max_det, generator arguments) at K 256, walked in rounds of 32 with
# 16 survivors settled a round (the kernel's 1024 and 512, scaled down)
WALK_CASES = [
    (200, 64, {}),
    (200, 300, {"levels": 5}),              # ties
    (200, 300, {"dup": 0.5}),               # duplicate boxes
    (200, 300, {"dup": 0.9, "levels": 3}),
    (0, 64, {}),                            # all dead
    (1, 64, {}),
    (20, 64, {}),                           # fewer live than max_det
    (32, 300, {}), (33, 300, {}), (31, 300, {}),   # L at a round boundary
    (16, 300, {}), (17, 300, {}),                  # L at the survivor boundary
    (64, 300, {}), (256, 300, {}),
    (256, 300, {"spread": 300.0}),          # crowded: most are suppressed
    (256, 10, {"spread": 300.0}),           # max_det ends the walk
]


@pytest.mark.parametrize("live,max_det,kw", WALK_CASES)
def test_ordered_walk_matches_plain_and_jax(live, max_det, kw):
    rng = np.random.default_rng(live + max_det)
    boxes, scores = sorted_candidates(rng, 3, 256, live, **kw)
    assert bool(nms_pallas.scores_ordered(scores).all())
    _, sc = assert_walk_matches(boxes, scores, 0.6, max_det, 32, 16)
    assert int((sc > 0).sum()) > 0 or live == 0


@pytest.mark.parametrize("chunk,surv", [(1024, 512), (64, 64), (8, 3),
                                        (5, 1)])
def test_ordered_walk_at_other_round_sizes(chunk, surv):
    boxes, scores = sorted_candidates(np.random.default_rng(8), 2, 300, 280,
                                      levels=11, dup=0.3, spread=600.0)
    assert_walk_matches(boxes, scores, 0.5, 100, chunk, surv)


def test_ordered_walk_on_a_dense_set():
    boxes, scores = dense_sorted_candidates(np.random.default_rng(9), 2, 1024,
                                            700, 12)
    _, sc = assert_walk_matches(boxes, scores, 0.6, 300, 64, 16)
    assert (sc > 0).sum(1).tolist() == [12, 12]  # one pick a cluster


def test_ordered_walk_property():
    """Any small sorted set, any round and survivor size: the walk's picks
    are the argmax loop's."""
    hypothesis = pytest.importorskip("hypothesis")
    st = hypothesis.strategies

    @hypothesis.settings(max_examples=40, deadline=None)
    @hypothesis.given(st.data())
    def walk(data):
        k = data.draw(st.integers(1, 24))
        live = data.draw(st.integers(0, k))
        grid = st.integers(0, 6)  # coarse coordinates: overlaps, ties abound
        xy = data.draw(st.lists(st.tuples(grid, grid, st.integers(1, 4),
                                          st.integers(1, 4)), min_size=k,
                                max_size=k))
        sc = sorted(data.draw(st.lists(st.integers(1, 5), min_size=k,
                                       max_size=k)), reverse=True)
        boxes = torch.tensor([[x, y, x + w, y + h] for x, y, w, h in xy],
                             dtype=torch.float32)[None] * 10
        scores = torch.tensor(sc, dtype=torch.float32)[None] / 8
        scores[0, live:] = -1.0
        iou = data.draw(st.sampled_from([0.0, 0.3, 0.6]))
        max_det = data.draw(st.integers(1, 30))
        chunk = data.draw(st.integers(1, 12))
        surv = data.draw(st.integers(1, chunk))
        want = nms_pallas.greedy_nms_plain(boxes, scores, iou, max_det)
        got = nms_pallas.greedy_nms_ordered_plain(boxes, scores, iou, max_det,
                                                  chunk, surv)
        assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])

    walk()


def test_scores_ordered_is_the_kernels_path_test():
    sb, ss = sorted_candidates(np.random.default_rng(10), 2, 64, 40, levels=4)
    ub, us = greedy_candidates(np.random.default_rng(10), 2, 64)
    assert nms_pallas.scores_ordered(ss).tolist() == [True, True]
    assert nms_pallas.scores_ordered(us).tolist() == [False, False]
    # a live score behind a dead one, and a rise among the live ones
    gap = ss.clone()
    gap[0, 50] = 0.001
    rise = ss.clone()
    rise[1, 10] = 2.0
    assert nms_pallas.scores_ordered(gap).tolist() == [False, True]
    assert nms_pallas.scores_ordered(rise).tolist() == [True, False]
    assert bool(nms_pallas.scores_ordered(torch.full((1, 8), -1.0)).all())
    with pytest.raises(ValueError, match="non-increasing"):
        nms_pallas.greedy_nms_ordered_plain(ub, us, 0.6, 10)
    # the validation path's top-k hands K3 that order
    pred = torch.from_numpy(make_pred(np.random.default_rng(11)))
    _, top_scores, _ = _prep_candidates(pred, 0.001, 512, True)
    assert bool(nms_pallas.scores_ordered(top_scores).all())


@pytest.mark.parametrize("seed", [12, 13])
def test_unsorted_sets_still_match_jax(seed):
    """Explicit candidates in any order (the kernel's argmax loop on the
    card; the plain version here)."""
    boxes, scores = greedy_candidates(np.random.default_rng(seed), 3, 200)
    assert not bool(nms_pallas.scores_ordered(scores).any())
    idx, sc = nms_pallas.greedy_nms_pallas(boxes, scores, 0.6, 80)
    j_idx, j_sc = jax_greedy(jnp.asarray(boxes.numpy()),
                             jnp.asarray(scores.numpy()), 0.6, 80,
                             interpret=True)
    np.testing.assert_array_equal(idx.numpy(), np.asarray(j_idx))
    np.testing.assert_array_equal(sc.numpy(), np.asarray(j_sc))
