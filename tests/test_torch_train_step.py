"""desenet_tpu_torch.train.make_train_step against the JAX package's
make_train_step on the CPU: tiny_psp2 at 64 px, batch 2, three steps from
one state carried by train_state_from_jax (non-zero momentum, a perturbed
EMA, counters past zero), the fused seg loss, SGD, a batch that always
steps (nominal_bs = batch_size). After each step: the loss and its
components, the parameters, the BN running statistics, the momentum buffer
and the EMA, and the counters exactly. Float64 forward and backward on both
sides (tests/torch_train_case.py says why, and holds the bars); the
accumulating, Adam, frozen and f32 cases are in test_torch_train_step_*.py,
the port's step alone in test_torch_train_port.py."""

import pytest

import torch_train_case as C

STEPS = 3


@pytest.fixture(scope="module")
def steps():
    return C.run_case(fused=True, adam=False, accum=False, steps=STEPS)


@pytest.mark.parametrize("what", C.CHECKS)
@pytest.mark.parametrize("step", range(STEPS))
def test_step_matches_jax(steps, step, what):
    C.check(steps[step], what, step)
    assert steps[step][1]["stepped"] == 1
