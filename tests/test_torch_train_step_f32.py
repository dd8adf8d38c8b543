"""desenet_tpu_torch.train.make_train_step against the JAX package's in
float32, the dtype a user trains in on the CPU: the materialized seg loss,
SGD, a batch that always steps, one step. At this size the f32 network
itself is the limit (desenet_tpu_torch/testing.py: JAX's own f32 step is
that far from its float64 one), so the bars are looser than the float64
cases'; they still catch any difference of semantics, which moves a tensor
by far more. A second check holds both packages' f32 steps against JAX's
float64 step: the port's lands no further from it than JAX's own does."""

import pytest

import torch_train_case as C

GROUPS = ("params", "stats", "mu", "ema")


@pytest.fixture(scope="module")
def steps():
    return C.run_case(fused=False, adam=False, accum=False, steps=1,
                      f64=False)


@pytest.fixture(scope="module")
def steps64():
    return C.run_case(fused=False, adam=False, accum=False, steps=1,
                      f64=True)


@pytest.mark.parametrize("what", C.CHECKS)
def test_step_matches_jax(steps, what):
    C.check(steps[0], what, 0, f64=False)


@pytest.mark.parametrize("what", GROUPS)
def test_port_f32_no_further_from_float64_than_jax_f32(steps, steps64, what):
    jax32, port32 = steps[0][2][what], steps[0][3][what]
    jax64 = steps64[0][2][what]
    as64 = lambda d: {k: v.double() for k, v in d.items()}  # noqa: E731
    port_err, _ = C.max_rel_err(jax64, as64(port32))
    jax_err, _ = C.max_rel_err(jax64, as64(jax32))
    assert 0 < jax_err and port_err <= jax_err, (port_err, jax_err)
