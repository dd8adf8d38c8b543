"""desenet_tpu_torch.train.make_train_step against the JAX package's, as in
test_torch_train_step.py, with freeze=2 (the first two DSL rows take no
gradient and keep their values; their momentum buffers and EMA still move,
as in the JAX step), the fused seg loss, SGD and an accumulating batch
(nominal_bs = 4 * batch_size), five steps from ni = 5."""

import pytest
import torch

import torch_train_case as C

STEPS = 5


@pytest.fixture(scope="module")
def steps():
    return C.run_case(fused=True, adam=False, accum=True, freeze=2,
                      steps=STEPS)


@pytest.mark.parametrize("what", C.CHECKS)
@pytest.mark.parametrize("step", range(STEPS))
def test_step_matches_jax(steps, step, what):
    C.check(steps[step], what, step)


def test_frozen_rows_keep_their_values(steps):
    first, last = steps[0][3]["params"], steps[-1][3]["params"]
    frozen = [k for k in last if k.startswith(("model.0.", "model.1."))]
    assert frozen
    for k in frozen:
        assert torch.equal(first[k], last[k]), k
    moved = [k for k in last if k not in frozen
             and not torch.equal(first[k], last[k])]
    assert moved
    assert [s[1]["stepped"] for s in steps] == [0, 0, 0, 1, 0]
