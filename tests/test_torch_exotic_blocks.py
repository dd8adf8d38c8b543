"""The blocks the model DSL cannot name (``desenet_tpu_torch/models/
layers.py``: ARM, ASPPs, RFB1, DAPPM, ConvBNReLU, Classify, Sum weighted
and plain) against their JAX modules on the CPU: variables made with numpy
from a seed in the shapes of the JAX block's, carried into the port's block
by ``utils/convert.block_state_dict_from_jax``, one input made with numpy
from a seed. In eval mode (running statistics) the outputs agree within 1e-5 in
f32; in training mode (batch statistics) the outputs, the gradients of
every parameter and input, and the moved BN running statistics agree in
float64 within ``testing.TRAIN_STATE_BAR``'s float64 bar, relative to each
tensor's largest magnitude (the JAX package takes a global pool's mean in
f32 whatever the dtype, about 1e-7 relative).

The BNs that never run (ARM's SE gate and each global branch: their input
map is 1x1) have no JAX variables; their running statistics are checked to
stay at their init in training.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import traverse_util

import desenet_tpu.models.layers as JL
import desenet_tpu_torch.models.layers as L
from desenet_tpu_torch.testing import TRAIN_STATE_BAR
from desenet_tpu_torch.utils.convert import (block_state_dict_from_jax,
                                             block_tree_from_jax)
from torch_detect_case import one_thread

F32_TOL = 1e-5
_threads = pytest.fixture(scope="module", autouse=True)(one_thread)
F64_BAR = TRAIN_STATE_BAR[torch.float64][0]


def check_rel(got, want, what):
    """max |got - want| over max |want| within the float64 bar."""
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape, what
    err = np.abs(got - want).max() / max(np.abs(want).max(), 1e-30)
    assert err <= F64_BAR, (what, err)

# name -> (JAX block of a compute dtype, port block, input channels, list
# input)
BLOCKS = {
    "ARM": (lambda dt: JL.ARM(24, dtype=dt), lambda: L.ARM(16, 24), 16,
            False),
    "ASPPs": (lambda dt: JL.ASPPs(24, dtype=dt), lambda: L.ASPPs(32, 24), 32,
              False),
    "ASPPs_noglobal": (
        lambda dt: JL.ASPPs(24, d=(2, 4, 6), has_global=False, dtype=dt),
        lambda: L.ASPPs(32, 24, d=(2, 4, 6), has_global=False), 32, False),
    "RFB1": (lambda dt: JL.RFB1(48, map_reduce=4, dtype=dt),
             lambda: L.RFB1(32, 48, map_reduce=4), 32, False),
    "RFB1_global": (
        lambda dt: JL.RFB1(48, map_reduce=4, has_global=True, dtype=dt),
        lambda: L.RFB1(32, 48, map_reduce=4, has_global=True), 32, False),
    "DAPPM": (lambda dt: JL.DAPPM(16, 32, dtype=dt),
              lambda: L.DAPPM(32, 16, 32), 32, False),
    "ConvBNReLU": (lambda dt: JL.ConvBNReLU(24, 3, dtype=dt),
                   lambda: L.ConvBNReLU(16, 24), 16, False),
    "ConvBNReLU_s2": (lambda dt: JL.ConvBNReLU(24, 3, 2, 1, 2, dtype=dt),
                      lambda: L.ConvBNReLU(16, 24, 3, 2, 1, 2), 16, False),
    "Classify": (lambda dt: JL.Classify(10, dtype=dt),
                 lambda: L.Classify(32, 10), 32, False),
    "Classify_list": (lambda dt: JL.Classify(10, k=1, dtype=dt),
                      lambda: L.Classify(48, 10), (32, 16), True),
    "Sum": (lambda dt: JL.Sum(3, dtype=dt), lambda: L.Sum(3), (8, 8, 8),
            True),
    "Sum_weighted": (lambda dt: JL.Sum(3, weight=True, dtype=dt),
                     lambda: L.Sum(3, weight=True), (8, 8, 8), True),
}


def _inputs(cin, as_list, dtype, seed=0):
    rng = np.random.default_rng(seed)
    chans = cin if as_list else (cin,)
    xs = [rng.standard_normal((2, 16, 16, c)).astype(dtype) for c in chans]
    return xs if as_list else xs[0]


def _to_torch(x):
    if isinstance(x, list):
        return [_to_torch(v) for v in x]
    return torch.from_numpy(np.ascontiguousarray(x.transpose(0, 3, 1, 2)))


def _out_np(y):
    y = y.detach().numpy()
    return y.transpose(0, 2, 3, 1) if y.ndim == 4 else y


@functools.lru_cache(maxsize=None)
def _variables(name):
    """Seeded numpy variables in the shapes of the JAX block's (its init
    traced by ``jax.eval_shape``, nothing computed): kernels N(0,
    1/fan_in), BN statistics and affine parameters away from identity."""
    jmod, _, cin, as_list = BLOCKS[name]
    x = _inputs(cin, as_list, np.float32)
    kw = {} if name.startswith("Sum") else {"train": False}
    shapes = jax.eval_shape(functools.partial(jmod(jnp.float32).init, **kw),
                            {"params": jax.random.PRNGKey(0)}, x)
    rng = np.random.default_rng(1)
    flat = {}
    for k, sh in traverse_util.flatten_dict(shapes, sep="/").items():
        shape = sh.shape
        if k.endswith("/kernel"):
            v = rng.standard_normal(shape) / np.sqrt(np.prod(shape[:-1]))
        elif k.endswith(("/var", "/scale")):
            v = rng.uniform(0.5, 1.5, shape)
        else:  # BN means and biases, conv biases, Sum's w
            v = rng.standard_normal(shape) * 0.1
        flat[k] = v
    return flat


def _make(name, dtype):
    """The JAX block with its variables, and the port block carrying
    them, in ``dtype``."""
    jmod, pmod, cin, as_list = BLOCKS[name]
    jm = jmod(jnp.float64 if dtype == np.float64 else jnp.float32)
    pm = pmod()
    flat = {k: v.astype(dtype) for k, v in _variables(name).items()}
    pm.load_state_dict(block_state_dict_from_jax(flat, pm))
    pm.to(torch.float64 if dtype == np.float64 else torch.float32)
    return jm, traverse_util.unflatten_dict(flat, sep="/"), pm, cin, as_list


@pytest.mark.parametrize("name", list(BLOCKS))
def test_block_forward_eval_f32(name):
    jm, v, pm, cin, as_list = _make(name, np.float32)
    x = _inputs(cin, as_list, np.float32, seed=2)
    jx = [jnp.asarray(a) for a in x] if as_list else jnp.asarray(x)
    kw = {} if name.startswith("Sum") else {"train": False}
    want = np.asarray(jax.jit(functools.partial(jm.apply, **kw))(v, jx))
    pm.eval()
    with torch.no_grad():
        got = _out_np(pm(_to_torch(x)))
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=F32_TOL, atol=F32_TOL)


@pytest.mark.parametrize("name", list(BLOCKS))
def test_block_train_mode_f64(name):
    """Training mode in float64: outputs, the gradient of the sum of
    squares of the output into each parameter and the input, and the BN
    running statistics after the step."""
    with jax.enable_x64(True):
        jm, v, pm, cin, as_list = _make(name, np.float64)
        x = _inputs(cin, as_list, np.float64, seed=3)
        jx = [jnp.asarray(a) for a in x] if as_list else jnp.asarray(x)
        params = v["params"] if "params" in v else {}
        stats = v.get("batch_stats", {})
        plain = name.startswith("Sum")

        def loss(p, xx):
            if plain:
                y, upd = jm.apply({"params": p}, xx), {}
            else:
                y, upd = jm.apply({"params": p, "batch_stats": stats}, xx,
                                  train=True, mutable=["batch_stats"])
            return jnp.sum(jnp.square(y)), (y, upd)

        (_, (jy, upd)), (jgp, jgx) = jax.jit(jax.value_and_grad(
            loss, argnums=(0, 1), has_aux=True))(params, jx)
        jy = np.asarray(jy)
        jgp = {k: np.asarray(a) for k, a in
               traverse_util.flatten_dict(jgp, sep="/").items()}
        new_stats = {f"batch_stats/{k}": np.asarray(a) for k, a in
                     traverse_util.flatten_dict(
                         dict(upd).get("batch_stats", {}), sep="/").items()}

    pm.train()
    xt = _to_torch(x)
    for t in (xt if as_list else [xt]):
        t.requires_grad_(True)
    before = {k: t.clone() for k, t in pm.state_dict().items()}
    y = pm(xt)
    (y * y).sum().backward()
    check_rel(_out_np(y.detach()), jy, "output")
    gx = [t.grad for t in (xt if as_list else [xt])]
    jgx = jgx if as_list else [jgx]
    for g, w in zip(gx, jgx):
        check_rel(_out_np(g), w, "input gradient")
    grads = block_tree_from_jax(
        {f"params/{k}": a for k, a in jgp.items()}, pm)
    quirk = tuple(getattr(pm, "quirk_bn_prefixes", lambda: [])())
    named = dict(pm.named_parameters())
    for k, p in named.items():
        if k.startswith(quirk):  # the BN that never runs takes no gradient
            assert p.grad is None and k not in grads, k
        else:
            check_rel(p.grad, grads[k], k)
    want_stats = block_tree_from_jax(new_stats, pm)
    after = pm.state_dict()
    for k in after:
        if not k.endswith(("running_mean", "running_var")):
            continue
        want = before[k] if k.startswith(quirk) or not new_stats \
            else want_stats[k]
        if k.startswith(quirk):  # never ran: exactly its init
            assert torch.equal(after[k], before[k]), k
        else:
            check_rel(after[k], want, k)
