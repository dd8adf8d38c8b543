"""``--remat`` (each DSL row under ``torch.utils.checkpoint`` in training,
``models/build.py``) on the CPU, tiny_psp2 at 64 px, batch 2, float64, the
fused seg loss, SGD, two steps from one state (``torch_train_case.setup``:
non-zero momentum, a perturbed EMA, counters past zero):

- the port's steps with remat equal its steps without, bit for bit: the
  losses, the parameters, the BN running statistics, the momentum and the
  EMA; with remat each row's forward runs twice a step (the recompute in
  the backward pass) and without it once, so the statistics moved once
  although the forward ran twice (``layers.checkpointed``);
- the port's remat steps against the JAX package's ``make_train_step`` on a
  model built with ``remat=True`` (flax's ``nn.remat``), held to
  ``testing``'s float64 bars as the other step tests are;
- the engine takes ``--remat``: its training model rematerializes, its eval
  twin does not.
"""

import os

import jax
import pytest
import torch

import torch_train_case as C
from desenet_tpu_torch.train import engine
from torch_detect_case import one_thread

STEPS = 2
_threads = pytest.fixture(scope="module", autouse=True)(one_thread)


def _port_steps(remat: bool):
    """The port's side of ``setup`` alone: STEPS steps, a snapshot after
    each, and how often row 2 (a C3) ran its forward."""
    with jax.enable_x64(True):
        c = C.setup(fused=True, adam=False, accum=False, remat=remat)
    pst, b = c["pst"], C.batch()
    calls = []
    # a pre-hook: the recompute stops once it has what the backward needs
    hook = pst.model.model[2].register_forward_pre_hook(
        lambda *a: calls.append(1))
    out = []
    try:
        for _ in range(STEPS):
            pst, pm = c["pstep"](pst, {k: torch.from_numpy(v)
                                       for k, v in b.items()})
            out.append(({k: float(v) for k, v in pm.items()},
                        C.port_snapshot(pst, adam=False)))
    finally:
        hook.remove()
    return out, len(calls)


@pytest.fixture(scope="module")
def port_pair():
    return _port_steps(False), _port_steps(True)


@pytest.fixture(scope="module")
def jax_remat():
    return C.run_case(fused=True, adam=False, accum=False, steps=STEPS,
                      remat=True)


@pytest.mark.parametrize("what", ["losses", "params", "stats", "mu", "ema",
                                  "counters"])
@pytest.mark.parametrize("step", range(STEPS))
def test_remat_steps_equal_plain_bitwise(port_pair, step, what):
    (plain, n_plain), (remat, n_remat) = port_pair
    # the recompute ran: one forward of the row a step without, two with
    assert (n_plain, n_remat) == (STEPS, 2 * STEPS)
    pm, ps = plain[step]
    rm, rs = remat[step]
    if what == "losses":
        assert rm == pm
    elif what == "counters":
        assert rs["counters"] == ps["counters"]
    else:
        assert set(rs[what]) == set(ps[what])
        for k, v in ps[what].items():
            assert torch.equal(rs[what][k], v), (what, k)


@pytest.mark.parametrize("what", C.CHECKS)
@pytest.mark.parametrize("step", range(STEPS))
def test_remat_steps_match_jax_remat(jax_remat, step, what):
    C.check(jax_remat[step], what, step)


def test_engine_takes_remat(tmp_path):
    cfg = engine.TrainConfig(cfg=os.path.join(C.HERE, "configs",
                                              "tiny_psp2.yaml"),
                             remat=True, device="cpu", dtype="float32",
                             batch_size=2, epochs=1, project=str(tmp_path))
    engine.check_processes(cfg, 1)  # accepted
    loop = engine.build_loop(cfg, engine.load_hyp(), 3, 2, 2, 64, "cpu", {})
    assert loop.state.model.remat and loop.state.model.training
    assert not loop.validator.model.remat
