"""desenet_tpu_torch.train.make_train_step against the JAX package's on the
seg heads with their own training paths: SegMaskBiSe (three outputs, the
aux-weighted seg loss: main + 1.5 aux_weight aux16 + 0.5 aux_weight aux32)
and SegMaskBase (1/8 logits through the tiled upsample + CE), each on the
tiny_psp2 graph at 64 px, batch 2, two SGD steps from one state in float64,
under the bars of tests/torch_train_case.py (desenet_tpu_torch/testing.py).

Both heads apply dropout in training, whose bits the two packages cannot
share (flax draws from its ``dropout`` rng); the steps are held without it:
flax's ``nn.Dropout`` is replaced by an identity for the JAX step and the
port's ``layers.Dropout`` gets p = 0. The dropout's own rate and scale are
held in test_torch_model_family.py.

The JAX variables are made in training mode, so that BiSe's aux heads have
them (the JAX package's eval-mode init makes none)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import linen as fnn

import torch_train_case as C
from desenet_tpu.losses import DetectionLoss as JDetectionLoss
from desenet_tpu.models import build_model as jax_build_model
from desenet_tpu.train import TrainState as JTrainState
from desenet_tpu.train import make_train_step as jax_make_train_step
from desenet_tpu.train import one_cycle as jax_one_cycle
from desenet_tpu.train.optim import OptimConfig as JOptimConfig
from desenet_tpu.train.optim import build_group_tree
from desenet_tpu.utils.torch_convert import convert_state_dict
from desenet_tpu_torch.losses import DetectionLoss
from desenet_tpu_torch.models import build_model, init_weights
from desenet_tpu_torch.models.layers import Dropout
from desenet_tpu_torch.train import make_train_step, one_cycle
from desenet_tpu_torch.train.optim import OptimConfig
from desenet_tpu_torch.utils.convert import train_state_from_jax
from test_torch_model_parity import load_cfg

STEPS = 2


class _NoDropout(fnn.Module):
    """Stands for flax's nn.Dropout in the JAX heads: returns its input."""

    rate: float
    deterministic: bool = False

    def __call__(self, x, deterministic=None, rng=None):
        return x


def run_head_case(name, steps=STEPS):
    with pytest.MonkeyPatch.context() as mp, jax.enable_x64(True):
        mp.setattr(fnn, "Dropout", _NoDropout)
        return _run(name, steps)


def _run(name, steps):
    cfg = load_cfg(name)
    jmodel, jspec = jax_build_model(cfg, seg_upsample=False,
                                    dtype=jnp.float64)
    model, spec = build_model(cfg, seg_upsample=False, train=True)
    init_weights(model, torch.Generator().manual_seed(0))
    drops = [m for m in model.modules() if isinstance(m, Dropout)]
    assert len(drops) == 1
    drops[0].p = 0.0
    template = jax.eval_shape(
        lambda: jmodel.init({"params": jax.random.PRNGKey(0),
                             "dropout": jax.random.PRNGKey(0)},
                            jnp.zeros((1, C.S, C.S, 3), jnp.float64),
                            train=True))
    template = jax.tree.map(lambda s: np.zeros(s.shape, np.float32), template)
    sd = {k: v.numpy() for k, v in model.state_dict().items()}
    variables, report = convert_state_dict(sd, template, jspec)
    assert not report["missing"]
    variables = jax.tree.map(lambda a: np.asarray(a, np.float64), variables)
    model.double()

    kw = dict(optimizer="sgd", lr0=C.LR0, warmup_bias_lr=C.WARMUP_BIAS_LR)
    jcfg, pcfg = JOptimConfig(**kw), OptimConfig(**kw)
    rng = np.random.default_rng(1)
    params, stats = variables["params"], variables["batch_stats"]
    mu = jax.tree.map(lambda a: np.asarray(
        rng.standard_normal(a.shape) * 1e-2, np.float64), params)
    ema = jax.tree.map(lambda a: np.float32(a) + np.float32(
        rng.standard_normal(a.shape) * 1e-3), params)
    ema_stats = jax.tree.map(np.float32, stats)
    start = 5
    dev = lambda t: jax.tree.map(jnp.asarray, t)  # noqa: E731
    jst = JTrainState(
        params=dev(params), batch_stats=dev(stats), opt_state=dev({"mu": mu}),
        accum_grads=dev(jax.tree.map(np.zeros_like, params)),
        ema_params=dev(ema), ema_batch_stats=dev(ema_stats),
        ema_updates=jnp.int32(start), step=jnp.int32(start),
        last_opt_step=jnp.int32(start - 1), groups=build_group_tree(params))
    jstate = {k: C._flat(v) for k, v in (
        ("params", params), ("batch_stats", stats), ("mu", mu),
        ("ema_params", ema), ("ema_batch_stats", ema_stats))}
    jstate.update(step=start, last_opt_step=start - 1, ema_updates=start)
    pst = train_state_from_jax(jstate, model, pcfg)

    common = dict(nb=4, warmup_iters=8, nominal_bs=C.B, batch_size=C.B,
                  ema_tau=4.0, fused_seg=True)
    jstep = jax_make_train_step(
        jmodel, JDetectionLoss(anchors=C.ANCHORS, nc=3), jcfg,
        jax_one_cycle(1, 0.2, 10), donate=False, compiler_options=None,
        **common)
    pstep = make_train_step(
        model, DetectionLoss(anchors=C.ANCHORS, nc=3), pcfg,
        one_cycle(1, 0.2, 10), dtype=torch.float64, **common)
    b = C.batch()
    jb = {k: jnp.asarray(v) for k, v in b.items()}
    out = []
    for _ in range(steps):
        jst, jm = jstep(jst, jb, jax.random.PRNGKey(0))
        pst, pm = pstep(pst, {k: torch.from_numpy(v) for k, v in b.items()},
                        torch.Generator().manual_seed(0))
        out.append(({k: float(v) for k, v in jm.items()},
                    {k: float(v) for k, v in pm.items()},
                    C.jax_snapshot(jst, spec, False),
                    C.port_snapshot(pst, False)))
    return out


@pytest.fixture(scope="module", params=["tiny_bise", "tiny_base"])
def steps(request):
    return request.param, run_head_case(request.param)


@pytest.mark.parametrize("what", C.CHECKS)
@pytest.mark.parametrize("step", range(STEPS))
def test_step_matches_jax(steps, step, what):
    name, out = steps
    C.check(out[step], what, step)
    assert out[step][1]["stepped"] == 1
    assert out[step][1]["lseg"] > 0
