"""Port upsample_argmax (plain PyTorch, the CPU path) vs the JAX
upsample_argmax with its Pallas kernel in interpret mode: the class maps
must be equal (both interpolate in f32 with the same _linear_matrix taps,
y pass then x pass, first channel on ties)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from desenet_tpu.ops.seg_pallas import upsample_argmax as jax_upsample_argmax
from desenet_tpu_torch.ops.resize import _linear_matrix
from desenet_tpu_torch.ops.seg_pallas import seg_taps, upsample_argmax


@pytest.mark.parametrize("b,c", [(8, 3), (4, 19), (6, 5), (1, 2)])
def test_matches_jax_kernel(b, c, rng):
    x = rng.normal(0, 1, (b, 10, 12, c)).astype(np.float32)
    want = np.asarray(jax_upsample_argmax(jnp.asarray(x), scale=8,
                                          interpret=True))
    got = upsample_argmax(torch.from_numpy(x), scale=8).numpy()
    assert got.dtype == np.uint8 and got.shape == (b, 80, 96)
    np.testing.assert_array_equal(got, want)


def test_bf16_input(rng):
    x = jnp.asarray(rng.normal(0, 1, (2, 8, 8, 3)), jnp.bfloat16)
    want = np.asarray(jax_upsample_argmax(x, scale=8, interpret=True))
    xt = torch.tensor(np.asarray(x.astype(jnp.float32))).to(torch.bfloat16)
    np.testing.assert_array_equal(upsample_argmax(xt, scale=8).numpy(), want)


def test_tie_breaks_to_first_channel():
    x = torch.ones((2, 8, 8, 4))
    assert (upsample_argmax(x, scale=8) == 0).all()


@pytest.mark.parametrize("n_in,n_out", [(10, 80), (12, 96), (1, 8), (80, 640)])
def test_taps_reproduce_the_matrix(n_in, n_out):
    idx, wts = seg_taps(n_in, n_out, True, torch.device("cpu"))
    m = np.zeros((n_out, n_in), np.float32)
    for i in range(n_out):
        m[i, idx[i, 0]] += wts[i, 0]
        m[i, idx[i, 1]] += wts[i, 1]
    np.testing.assert_array_equal(m, _linear_matrix(n_in, n_out, True))


def test_checks_its_input():
    with pytest.raises(ValueError, match="contiguous"):
        upsample_argmax(torch.zeros(1, 3, 8, 8).permute(0, 2, 3, 1))
    with pytest.raises(TypeError, match="float32 or bfloat16"):
        upsample_argmax(torch.zeros(1, 8, 8, 3, dtype=torch.float16))
    with pytest.raises(ValueError, match="CPU or CUDA"):
        upsample_argmax(torch.zeros(1, 8, 8, 3, device="meta"))


# ---- the span kernel's reading of the taps, and the choice of kernel --------

TAP_CASES = [(80, 640, True), (80, 640, False), (10, 80, True),
             (12, 96, False), (80, 320, True), (40, 480, True),
             (80, 1280, True), (80, 80, True), (1, 8, True), (7, 21, False),
             (24, 48, False)]
# half-pixel centres clamp several pixels onto the first source: one-tap
# pixels past the first of a run, which the span kernel does not read so
CLAMPED = {(80, 640, False), (12, 96, False), (7, 21, False)}


@pytest.mark.parametrize("n_in,n_out,align", TAP_CASES)
def test_tap_runs_partition_the_output(n_in, n_out, align):
    """Run k holds exactly the output pixels whose first tap is source k,
    and the span kernel's second tap (the next source, the last one staying)
    is the table's wherever that tap carries weight; the reading holds
    where every one-tap pixel is the first of its run or in the last."""
    from desenet_tpu_torch.ops.seg_pallas import tap_runs

    idx, wts = (t.numpy() for t in seg_taps(n_in, n_out, align,
                                            torch.device("cpu")))
    starts, run, ok = tap_runs(n_in, n_out, align)
    assert starts.shape == (n_in + 1,) and starts[0] == 0
    assert starts[-1] == n_out
    assert ok == ((n_in, n_out, align) not in CLAMPED)
    first = np.repeat(np.arange(n_in), np.diff(starts))
    np.testing.assert_array_equal(first, idx[:, 0])
    assert run == np.bincount(idx[:, 0], minlength=n_in).max()
    second = np.minimum(first + 1, n_in - 1)
    assert np.all((second == idx[:, 1]) | (wts[:, 1] == 0))
    if ok:
        one_tap = np.flatnonzero((wts[:, 1] == 0) & (first < n_in - 1))
        assert np.all(np.isin(one_tap, starts))


@pytest.mark.parametrize("n_in,n_out,align", TAP_CASES)
def test_span_reading_gives_the_plain_class_map(n_in, n_out, align, rng):
    """Blending every pixel of run k from sources k and k + 1, the first
    pixel from k twice when its second weight is 0 (what the span kernel
    does), gives upsample_argmax_plain's map bit for bit: on finite logits
    for every table, and with an infinite one beside a pixel that sits on
    its source wherever the kernel takes the table."""
    from desenet_tpu_torch.ops.seg_pallas import (tap_runs,
                                                  upsample_argmax_plain)

    dev = torch.device("cpu")
    ys, wy = seg_taps(6, 48, align, dev)
    xs, wx = seg_taps(n_in, n_out, align, dev)
    starts, _, ok = tap_runs(n_in, n_out, align)
    first = np.repeat(np.arange(n_in), np.diff(starts))
    second = np.minimum(first + 1, n_in - 1)
    on_source = (np.arange(n_out) == starts[first]) & (wx[:, 1].numpy() == 0)
    span_xs = torch.from_numpy(np.stack(
        [first, np.where(on_source, first, second)], 1).astype(np.int32))
    for dtype in (torch.float32, torch.bfloat16):
        x = torch.from_numpy(rng.normal(0, 1, (2, 6, n_in, 5)).astype(
            np.float32)).to(dtype)
        want = upsample_argmax_plain(x, ys, wy, xs, wx)
        got = upsample_argmax_plain(x, ys, wy, span_xs, wx)
        assert torch.equal(got, want)
        if ok and n_in > 1:
            x[:, :, 0, 2] = -5.0
            x[:, 1:5, 1, 2] = float("inf")   # beside source 0's one-tap pixel
            x[:, 1:5, -1, 3] = float("-inf")
            want = upsample_argmax_plain(x, ys, wy, xs, wx)
            assert torch.equal(
                upsample_argmax_plain(x, ys, wy, span_xs, wx), want)
            assert want[0, 10, 0] != 2   # the neighbour's inf kept out


@pytest.mark.parametrize("w,scale,align,variant", [
    (80, 8, True, "span"),       # the served shape: runs of 8 or 9
    (80, 8, False, "pixel"),     # half-pixel centres: a run of 12
    (80, 4, True, "span"),
    (40, 12, True, "pixel"),     # runs of 13
    (10, 8, True, "span"),
    (80, 16, True, "pixel"),     # runs of 17
    (81, 8, True, "pixel"),      # 648 columns: no multiple of 16
    (1, 8, True, "pixel"),
    (600, 8, True, "pixel"),     # more source columns than a block
    (80, 1, True, "span"),
    (24, 2, False, "span"),      # one clamped pixel, the first of its run
    (80, 4, False, "pixel"),     # two clamped pixels in the first run
])
def test_pick_variant_by_shape(w, scale, align, variant):
    from desenet_tpu_torch.ops import seg_pallas

    assert seg_pallas.pick_variant(w, w * scale, align) == variant
    cfg = seg_pallas.span_config(w, w * scale, align)
    if variant == "pixel":
        assert cfg is None
        return
    g, rpt = cfg
    assert seg_pallas.tap_runs(w, w * scale, align)[1] <= seg_pallas.SPAN_RUN
    assert 1 <= w * g <= seg_pallas.SPAN_THREADS and rpt >= 1
    assert g * rpt * w * scale <= seg_pallas.SPAN_TILE_BYTES


def test_span_constants_are_the_sources():
    import os
    import re

    from desenet_tpu_torch.ops import _ext, seg_pallas

    with open(os.path.join(_ext.CSRC, "seg_tail.cu")) as fh:
        src = fh.read()
    assert int(re.search(r"kSpanThreads = (\d+);", src)[1]) == \
        seg_pallas.SPAN_THREADS
    assert "smem > 48 * 1024" in src and seg_pallas.SPAN_TILE_BYTES == 48 * 1024
    assert int(re.search(r"kSpanRun = (\d+);", src)[1]) == seg_pallas.SPAN_RUN
    assert len(re.findall(r"seg_tail_span_kernel<T><<<", src)) == 1


def test_named_kernel_refuses_the_cpu_and_unknown_names():
    from desenet_tpu_torch.ops.seg_pallas import upsample_argmax_with

    with pytest.raises(ValueError, match="runs on CUDA"):
        upsample_argmax_with(torch.zeros(1, 8, 8, 3), "span")
    with pytest.raises(ValueError, match="runs on CUDA"):
        upsample_argmax_with(torch.zeros(1, 8, 8, 3, device="meta"), "pixel")
