"""desenet_tpu_torch.train.make_train_step against the JAX package's, as in
test_torch_train_step.py, for the materialized seg loss (the model's
full-resolution logits through segmentation_loss), Adam, and an
accumulating batch: nominal_bs = 4 * batch_size, so the step takes an
optimizer step only when the warmup-interpolated count of batches has
gathered (tests/test_train_step.py:82-100). Five steps from ni = 5 of an
8-batch warmup: the stepped pattern, the counters, and after every step the
losses, parameters, BN statistics, both Adam moments and the EMA."""

import pytest

import torch_train_case as C

STEPS = 5


@pytest.fixture(scope="module")
def steps():
    return C.run_case(fused=False, adam=True, accum=True, steps=STEPS)


@pytest.mark.parametrize("what", C.CHECKS + ("nu",))
@pytest.mark.parametrize("step", range(STEPS))
def test_step_matches_jax(steps, step, what):
    C.check(steps[step], what, step)


def test_stepped_pattern(steps):
    # accumulate = round(1 + 3 * ni / 8): 3, 3, 4, 4 at ni 5..8, so the
    # batches of ni 5, 6 and 7 gather and ni 8 steps, then 9 gathers again
    assert [s[1]["stepped"] for s in steps] == [0, 0, 0, 1, 0]
    assert [s[0]["stepped"] for s in steps] == [0, 0, 0, 1, 0]
