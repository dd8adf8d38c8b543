"""Shared set-up of the training-step parity tests: tiny_psp2 at 64 px,
batch 2, the same state on both sides.

The port's seeded init (``init_weights``) fills the JAX variables
(``convert_state_dict`` over an ``eval_shape`` template, so that no JAX
init runs); the JAX ``TrainState`` made from them gets non-zero optimizer
buffers, a perturbed EMA and counters past zero, and crosses to the port
through ``train_state_from_jax``. Then both packages take the same steps on
the same batch and each side's state is kept, step by step, in the port's
keys."""

import os

import jax
import jax.numpy as jnp
import numpy as np
import torch
import yaml
from flax import traverse_util

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
from desenet_tpu_torch.train import make_train_step, one_cycle
from desenet_tpu_torch.train.optim import OptimConfig
from desenet_tpu_torch.testing import TRAIN_LOSS_BAR, TRAIN_STATE_BAR
from desenet_tpu_torch.train.state import bn_stats
from desenet_tpu_torch.utils.convert import train_state_from_jax, tree_from_jax

HERE = os.path.dirname(os.path.abspath(__file__))
S, B, M = 64, 2, 8
LR0, WARMUP_BIAS_LR = 1e-3, 1e-2
ANCHORS = (((1.25, 1.625), (2.0, 3.75), (4.125, 2.875)),
           ((1.875, 3.8125), (3.875, 2.8125), (3.6875, 7.4375)),
           ((3.625, 2.8125), (4.875, 6.1875), (11.65625, 10.1875)))


def tiny_cfg():
    with open(os.path.join(HERE, "configs", "tiny_psp2.yaml")) as fh:
        return yaml.safe_load(fh)


def batch(seed=0, b=B):
    """uint8 images, 2 + i targets in image i (up to M), uint8 seg labels
    with a blob under each box (tests/test_train_step.py's shapes)."""
    rng = np.random.default_rng(seed)
    img = rng.integers(0, 256, (b, S, S, 3), dtype=np.uint8)
    seg = np.zeros((b, S, S), np.uint8)
    tg = np.zeros((b, M, 5), np.float32)
    mask = np.zeros((b, M), bool)
    for i in range(b):
        n = 2 + i
        for j in range(n):
            cx, cy = rng.uniform(0.25, 0.75, 2)
            w, h = rng.uniform(0.1, 0.4, 2)
            tg[i, j] = [rng.integers(0, 3), cx, cy, w, h]
            mask[i, j] = True
            y0, y1 = int((cy - h / 2) * S), int((cy + h / 2) * S)
            x0, x1 = int((cx - w / 2) * S), int((cx + w / 2) * S)
            seg[i, y0:y1, x0:x1] = 1
            img[i, y0:y1, x0:x1] = (200, 30, 30)
    return {"image": img, "det_targets": tg, "det_mask": mask,
            "seg_labels": seg}


def _flat(tree):
    return {k: np.asarray(v) for k, v in
            traverse_util.flatten_dict(jax.device_get(tree), sep="/").items()}



def jax_snapshot(st, spec, adam):
    """A JAX TrainState in the port's keys."""
    out = {"params": tree_from_jax(_flat(st.params), spec),
           "stats": tree_from_jax(_flat(st.batch_stats), spec),
           "mu": tree_from_jax(_flat(st.opt_state["mu"]), spec),
           "ema": {**tree_from_jax(_flat(st.ema_params), spec),
                   **tree_from_jax(_flat(st.ema_batch_stats), spec)},
           "counters": (int(st.step), int(st.last_opt_step),
                        int(st.ema_updates))}
    if adam:
        out["nu"] = tree_from_jax(_flat(st.opt_state["nu"]), spec)
    return out


def port_snapshot(st, adam):
    c = lambda d: {k: v.detach().double().clone() for k, v in d.items()}  # noqa
    out = {"params": c(st.params), "stats": c(bn_stats(st.model)),
           "mu": c(st.opt_state["mu"]), "ema": c(st.ema),
           "counters": (st.step, st.last_opt_step, st.ema_updates)}
    if adam:
        out["nu"] = c(st.opt_state["nu"])
    return out


def run_case(fused, adam, accum, freeze=0, steps=3, start=5, f64=True,
             remat=False):
    """Both packages take ``steps`` steps from one state. Returns a list of
    (jax metrics, port metrics, jax snapshot, port snapshot) per step.
    ``remat``: both models rematerialize each row in training (JAX's
    ``nn.remat``, the port's ``torch.utils.checkpoint``).

    ``f64``: both forward and backward passes, the weights and the
    optimizer buffers in float64 (JAX under ``jax.enable_x64``, its model
    with ``dtype=float64`` on float64 variables; the port's model
    ``.double()``); the losses, the seg upsample's contractions and the EMA
    stay float32 on both sides, as in the f32 step."""
    with jax.enable_x64(f64):
        return _run_case(fused, adam, accum, freeze, steps, start, f64,
                         remat)


def _run_case(fused, adam, accum, freeze, steps, start, f64, remat=False):
    c = setup(fused, adam, accum, freeze, start, f64, remat=remat)
    b = batch()
    jb = {k: jnp.asarray(v) for k, v in b.items()}
    jst, pst = c["jst"], c["pst"]
    out = []
    for _ in range(steps):
        jst, jm = c["jstep"](jst, jb, jax.random.PRNGKey(0))
        pst, pm = c["pstep"](pst, {k: torch.from_numpy(v)
                                   for k, v in b.items()})
        out.append(({k: float(v) for k, v in jm.items()},
                    {k: float(v) for k, v in pm.items()},
                    jax_snapshot(jst, c["spec"], adam),
                    port_snapshot(pst, adam)))
    return out


def setup(fused, adam, accum, freeze=0, start=5, f64=True, b=B,
          remat=False):
    """One state on both sides and both steps, for a (global) batch of
    ``b``: a dict of the JAX ``jst``/``jstep``, the port's ``pst``/
    ``pstep``, the port's ``spec`` and what rebuilds the port's side in
    another process (``jstate`` as numpy, ``cfg``, ``opt`` and ``common``
    keywords). Call under ``jax.enable_x64(f64)``."""
    cfg = tiny_cfg()
    jdt = jnp.float64 if f64 else jnp.float32
    jmodel, jspec = jax_build_model(cfg, seg_upsample=not fused, dtype=jdt,
                                    remat=remat)
    model, spec = build_model(cfg, seg_upsample=not fused, train=True,
                              remat=remat)
    init_weights(model, torch.Generator().manual_seed(0))
    template = jax.eval_shape(
        lambda: jmodel.init({"params": jax.random.PRNGKey(0),
                             "dropout": jax.random.PRNGKey(0)},
                            jnp.zeros((1, S, S, 3), jdt), train=False))
    template = jax.tree.map(lambda s: np.zeros(s.shape, np.float32), template)
    sd = {k: v.numpy() for k, v in model.state_dict().items()}
    variables, _ = convert_state_dict(sd, template, jspec)
    ndt = np.float64 if f64 else np.float32
    variables = jax.tree.map(lambda a: np.asarray(a, ndt), variables)
    if f64:
        model.double()

    kw = dict(optimizer="adam" if adam else "sgd", lr0=LR0,
              warmup_bias_lr=WARMUP_BIAS_LR)
    jcfg, pcfg = JOptimConfig(**kw), OptimConfig(**kw)
    rng = np.random.default_rng(1)

    def like(tree, scale, dtype, positive=False):
        def f(x):
            r = rng.standard_normal(x.shape).astype(np.float32) * scale
            return np.asarray(np.abs(r) if positive else r, dtype)
        return jax.tree.map(f, tree)

    # the JAX TrainState built from numpy (create_train_state's per-leaf
    # jnp ops would each compile): momentum buffers and a perturbed EMA
    # that are not zero, counters past zero
    params, stats = variables["params"], variables["batch_stats"]
    trees = {
        "params": params, "batch_stats": stats,
        "mu": like(params, 1e-2, ndt),
        "ema_params": jax.tree.map(lambda a, n: np.float32(a) + n, params,
                                   like(params, 1e-3, np.float32)),
        "ema_batch_stats": jax.tree.map(np.float32, stats)}
    opt = {"mu": trees["mu"]}
    if adam:
        trees["nu"] = like(params, 1e-4, ndt, positive=True)
        opt.update(nu=trees["nu"], count=np.int32(start))
    dev = lambda t: jax.tree.map(jnp.asarray, t)  # noqa: E731
    jst = JTrainState(
        params=dev(params), batch_stats=dev(stats), opt_state=dev(opt),
        accum_grads=dev(jax.tree.map(np.zeros_like, params)),
        ema_params=dev(trees["ema_params"]),
        ema_batch_stats=dev(trees["ema_batch_stats"]),
        ema_updates=jnp.int32(start), step=jnp.int32(start),
        last_opt_step=jnp.int32(start - 1), groups=build_group_tree(params))
    jstate = {k: _flat(v) for k, v in trees.items()}
    jstate.update(step=start, last_opt_step=start - 1, ema_updates=start,
                  count=start)
    pst = train_state_from_jax(jstate, model, pcfg)

    nominal = 4 * b if accum else b
    # tau 4, not 2000: at u / tau = 0.003 the f32 decay 1 - exp(-u / tau)
    # keeps about 2e-5 of relative accuracy, and XLA's f32 exp and numpy's
    # differ there by that much
    common = dict(nb=4, warmup_iters=8, nominal_bs=nominal, batch_size=b,
                  freeze=freeze, ema_tau=4.0)
    jdet = JDetectionLoss(anchors=ANCHORS, nc=3)
    pdet = DetectionLoss(anchors=ANCHORS, nc=3)
    jstep = jax_make_train_step(jmodel, jdet, jcfg, jax_one_cycle(1, 0.2, 10),
                                donate=False, compiler_options=None,
                                fused_seg=fused, **common)
    pstep = make_train_step(model, pdet, pcfg, one_cycle(1, 0.2, 10),
                            fused_seg=fused,
                            dtype=torch.float64 if f64 else torch.float32,
                            **common)
    return dict(jst=jst, jstep=jstep, pst=pst, pstep=pstep, spec=spec,
                jstate=jstate, cfg=cfg, opt=kw, common=common)


# the bars, shared with the card's check (testing.py says where they come
# from): the loss relative, each state tensor against its largest magnitude
LOSS_BAR = {f64: TRAIN_LOSS_BAR[torch.float64 if f64 else torch.float32]
            for f64 in (True, False)}
STATE_BAR = {f64: TRAIN_STATE_BAR[torch.float64 if f64 else torch.float32]
             for f64 in (True, False)}
CHECKS = ("losses", "params", "stats", "mu", "ema", "counters")


def check(step_out, what, step, f64=True):
    """Hold one step's port result against JAX's for one of CHECKS (or
    'nu')."""
    jm, pm, js, ps = step_out
    if what == "losses":
        for k in ("loss", "lbox", "lobj", "lcls", "lseg", "lr"):
            np.testing.assert_allclose(pm[k], jm[k], rtol=LOSS_BAR[f64],
                                       atol=0, err_msg=k)
    elif what == "counters":
        assert ps["counters"] == js["counters"]
        assert pm["stepped"] == jm["stepped"]
    else:
        bar = STATE_BAR[f64][min(step, 1)]
        err, key = max_rel_err(js[what], ps[what])
        assert err <= bar, (what, key, err)


def max_rel_err(want: dict, got: dict):
    """Per tensor: max |got - want| over max |want| (1 where want is 0)."""
    assert set(want) == set(got), sorted(set(want) ^ set(got))[:5]
    worst = (0.0, None)
    for k, w in want.items():
        scale = max(float(w.abs().max()), 1e-30)
        e = float((got[k] - w).abs().max()) / scale
        worst = max(worst, (e, k), key=lambda t: t[0])
    return worst


def drift(fused=True, steps=3):
    """Per step, each group's worst error against JAX's float64 step: of
    JAX's own f32 step, of the port's f32 step and of the port's float64
    step (``max_rel_err``; the loss relative)."""
    runs = {f64: run_case(fused=fused, adam=False, accum=False, steps=steps,
                          f64=f64) for f64 in (True, False)}
    out = []
    for (j64m, p64m, j64, p64), (j32m, p32m, j32, p32) in zip(runs[True],
                                                              runs[False]):
        row = {}
        for name, m, snap in (("jax f32", j32m, j32), ("port f32", p32m, p32),
                              ("port f64", p64m, p64)):
            row[name] = {"loss": abs(m["loss"] - j64m["loss"])
                         / abs(j64m["loss"])}
            for g in ("params", "stats", "mu", "ema"):
                row[name][g] = max_rel_err(
                    j64[g], {k: v.double() for k, v in snap[g].items()})
        out.append(row)
    return out


if __name__ == "__main__":
    # JAX_PLATFORMS=cpu PYTHONPATH=. python tests/torch_train_case.py:
    # how far one package's f32 training steps drift from JAX's float64 ones
    for i, row in enumerate(drift()):
        for name, errs in row.items():
            print(f"step {i} {name} against JAX float64: " + ", ".join(
                f"{g} {e:.3g}" if g == "loss" else f"{g} {e[0]:.3g} ({e[1]})"
                for g, e in errs.items()))
