"""The port's training step in two processes (gloo on the CPU) against the
JAX package's ``make_train_step`` on the global batch.

tiny_psp2 at 64 px, a global batch of 4 split 2 + 2 over the processes
(``tests/torch_dist_worker.py``); the ranks hold different target counts
(2 + 3 against 4 + 5) and different ignore pixels (label -1), so a
per-process mean followed by an average over the processes would not be
the global batch's loss. From one state carried by ``train_state_from_jax``
both take three steps in float64 (``tests/torch_train_case.py``): after
each, rank 0's loss and components, parameters, BN running statistics,
momentum, EMA and counters against JAX's, to the bars of ``testing.py``;
rank 1's state equals rank 0's exactly. The fused and the materialized
seg loss, and an accumulating batch (gradients summed over the processes
at the optimizer step).
"""

import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_train_case as C
from desenet_tpu_torch.parallel.multihost import free_port

HERE = os.path.dirname(os.path.abspath(__file__))
REPO = os.path.dirname(HERE)
NPROC, B_GLOBAL, STEPS = 2, 4, 3
CASES = {"fused": dict(fused=True, accum=False),
         "materialized": dict(fused=False, accum=False),
         "accumulating": dict(fused=True, accum=True)}


def global_batch():
    """``C.batch`` at 4 images, seg labels int32 with ignore pixels: a band
    in image 1 (rank 0) and a larger block in image 3 (rank 1)."""
    b = C.batch(seed=2, b=B_GLOBAL)
    seg = b["seg_labels"].astype(np.int32)
    seg[1, :4] = -1
    seg[3, 20:50, 10:60] = -1
    return {**b, "seg_labels": seg}


def launch(case: dict, tmp_path) -> list:
    """Run the workers on ``case``; each rank's per-step results."""
    case_path, out = str(tmp_path / "case.pt"), str(tmp_path / "out.pt")
    torch.save(case, case_path)
    coord = f"localhost:{free_port()}"
    env = dict(os.environ, PYTHONPATH=os.pathsep.join([REPO, HERE]),
               OMP_NUM_THREADS="1")
    procs = [subprocess.Popen(
        [sys.executable, os.path.join(HERE, "torch_dist_worker.py"), coord,
         str(NPROC), str(r), case_path, out], env=env, cwd=REPO,
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for r in range(NPROC)]
    logs = [p.communicate(timeout=300)[0] for p in procs]
    for p, log in zip(procs, logs):
        assert p.returncode == 0, log[-4000:]
    return [torch.load(f"{out}.{r}", weights_only=False)
            for r in range(NPROC)]


@pytest.fixture(scope="module", params=list(CASES))
def runs(request, tmp_path_factory):
    kw = CASES[request.param]
    b = global_batch()
    with jax.enable_x64(True):
        c = C.setup(adam=False, b=B_GLOBAL, **kw)
        jb = {k: jnp.asarray(v) for k, v in b.items()}
        jst, want = c["jst"], []
        for _ in range(STEPS):
            jst, jm = c["jstep"](jst, jb, jax.random.PRNGKey(0))
            want.append(({k: float(v) for k, v in jm.items()},
                         C.jax_snapshot(jst, c["spec"], False)))
    case = dict(cfg=c["cfg"], fused=kw["fused"], f64=True, opt=c["opt"],
                common=c["common"], jstate=c["jstate"], batch=b,
                steps=STEPS, anchors=C.ANCHORS)
    got = launch(case, tmp_path_factory.mktemp("dist_" + request.param))
    return request.param, want, got


@pytest.mark.parametrize("step", range(STEPS))
def test_two_processes_match_jax_on_the_global_batch(runs, step):
    name, want, got = runs
    (jm, js), (pm, ps) = want[step], got[0][step]
    step_out = (jm, pm, js, ps)
    for what in C.CHECKS:
        C.check(step_out, what, step)
    if name != "accumulating":
        assert pm["stepped"] == 1


def test_ranks_hold_one_state(runs):
    _, _, got = runs
    for (m0, s0), (m1, s1) in zip(*got):
        assert m0 == m1
        assert s0["counters"] == s1["counters"]
        for g in ("params", "stats", "mu", "ema"):
            for k, v in s0[g].items():
                assert torch.equal(v, s1[g][k]), (g, k)


def test_the_ranks_hold_different_counts():
    b = global_batch()
    rows = [slice(0, 2), slice(2, 4)]
    assert [int(b["det_mask"][r].sum()) for r in rows] == [5, 9]
    assert [int((b["seg_labels"][r] == -1).sum()) for r in rows] == [
        4 * 64, 30 * 50]
