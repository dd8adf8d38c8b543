"""Shared case of the inference and validation slice's tests
(tests/test_torch_{detect,tta_ensemble,plots_sources}.py): tiny_psp2's
weights (``test_torch_slice.served_weights``, member ``k`` > 0 perturbed
by seeded noise) in a JAX (orbax) checkpoint, crossed into a port
checkpoint through ``utils/convert.py:train_state_from_jax``, and JAX and
port models on them in f32.

The checkpoints hold different ``params`` and ``ema``: the EMA is the
member's weights, the parameters are noise around them, so a loader that
took the parameters instead of the EMA would disagree with the other
package.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import torch
from flax import traverse_util

from desenet_tpu.models import build_model as jax_build_model
from desenet_tpu.train import TrainState as JTrainState
from desenet_tpu.train.optim import build_group_tree
from desenet_tpu.utils import checkpoint as jax_ckpt
from desenet_tpu.utils.torch_convert import convert_state_dict
from desenet_tpu_torch.models import build_model
from desenet_tpu_torch.train import engine
from desenet_tpu_torch.utils import checkpoint as ckpt
from desenet_tpu_torch.utils.convert import train_state_from_jax
from test_torch_slice import served_weights, tiny_cfg

HERE = os.path.dirname(os.path.abspath(__file__))
CFG = os.path.join(HERE, "configs", "tiny_psp2.yaml")
DE_NAMES = ["car", "person", "sign"]
SE_NAMES = ["bg", "road"]


def meta() -> dict:
    return {"cfg": CFG, "imgsz": 64, "de_nc": 3, "se_nc": 2,
            "de_names": list(DE_NAMES), "se_names": list(SE_NAMES),
            "hyp": {"lr0": 0.01}}


def member_weights(k: int) -> dict:
    """Member ``k``'s torch-named numpy weights: ``served_weights`` for 0,
    every float tensor moved by 3% of its spread otherwise."""
    sd = served_weights()
    if k == 0:
        return sd
    rng = np.random.default_rng(100 + k)
    out = {}
    for name, v in sd.items():
        if v.dtype.kind == "f" and not name.endswith("running_var"):
            v = v + rng.standard_normal(v.shape).astype(v.dtype) * (
                0.03 * float(v.std()) if v.size > 1 else 0.0)
        out[name] = v
    return out


def jax_variables(sd: dict, seg_upsample: bool = True):
    """(JAX model, variables) of torch-named numpy weights ``sd``."""
    model, spec = jax_build_model(tiny_cfg(), seg_upsample=seg_upsample)
    x = jax.ShapeDtypeStruct((1, 64, 64, 3), np.float32)
    shapes = jax.eval_shape(
        lambda v: model.init({"params": jax.random.PRNGKey(0),
                              "dropout": jax.random.PRNGKey(0)}, v,
                             train=False), x)
    template = jax.tree.map(lambda s: np.zeros(s.shape, s.dtype), shapes)
    variables, report = convert_state_dict(sd, template, spec)
    assert not report["missing"]
    return model, variables


def _flat(tree):
    return {k: np.asarray(v) for k, v in
            traverse_util.flatten_dict(tree, sep="/").items()}


def write_checkpoints(root: str, k: int, weights=None):
    """(JAX checkpoint dir, port checkpoint dir) of member ``k``, or of the
    torch-named numpy ``weights`` where given."""
    _, variables = jax_variables(member_weights(k) if weights is None
                                 else weights)
    params, stats = variables["params"], variables["batch_stats"]
    rng = np.random.default_rng(7 + k)
    noisy = jax.tree.map(
        lambda a: a + rng.standard_normal(a.shape).astype(np.float32), params)
    dev = lambda t: jax.tree.map(jnp.asarray, t)  # noqa: E731
    jstate = JTrainState(
        params=dev(noisy), batch_stats=dev(stats),
        opt_state=dev({"mu": jax.tree.map(np.zeros_like, params)}),
        accum_grads=dev(jax.tree.map(np.zeros_like, params)),
        ema_params=dev(params), ema_batch_stats=dev(stats),
        ema_updates=jnp.int32(4), step=jnp.int32(4),
        last_opt_step=jnp.int32(3), groups=build_group_tree(params))
    jdir, pdir = os.path.join(root, f"jax{k}"), os.path.join(root, f"port{k}")
    jax_ckpt.save_checkpoint(jdir, jstate, 1, 0.0, meta())
    payload = jax_ckpt.load_checkpoint(jdir)
    c = payload["counters"]
    crossing = {key: _flat(payload[key]) for key in (
        "params", "batch_stats", "ema_params", "ema_batch_stats")}
    crossing.update(mu=_flat(payload["opt_state"]["mu"]), step=int(c["step"]),
                    ema_updates=int(c["ema_updates"]),
                    last_opt_step=int(c["last_opt_step"]))
    model, _ = build_model(tiny_cfg(), seg_upsample=False, train=True)
    opt_cfg = engine.loss_and_schedule(engine.load_hyp(), model.spec, 64,
                                       4)[1]
    state = train_state_from_jax(crossing, model, opt_cfg)
    ckpt.save_checkpoint(pdir, state, int(c["epoch"]),
                         float(c["best_fitness"]), meta())
    return jdir, pdir


def port_model(k: int = 0, **kw):
    """The port's f32 eval model of member ``k`` on the CPU."""
    model, _ = build_model(tiny_cfg(), fuse_focus=True, **kw)
    from desenet_tpu_torch.utils.convert import load_state_dict

    load_state_dict(model, {n: torch.from_numpy(v)
                            for n, v in member_weights(k).items()})
    return model


def one_thread():
    """Generator for an autouse module fixture: torch on one intra-op
    thread (the parallel test workers then do not oversubscribe)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)
