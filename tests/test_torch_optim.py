"""desenet_tpu_torch.train's optimizer, EMA, schedules and group tags
against the JAX package's, on the same arrays (numpy, seeded), from
non-zero buffers; and the flax-style BatchNorm's running variance.

Bars: the per-step scalars are f32 on both sides, so the updated tensors
agree within 1e-6 of each tensor's largest magnitude (a few f32 roundings
apart: fused multiply-adds and operation order)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch import nn

from desenet_tpu.train import ema as jema
from desenet_tpu.train import optim as jopt
from desenet_tpu.train import schedule as jsched
from desenet_tpu_torch.models.layers import batch_norm
from desenet_tpu_torch.train import ema as pema
from desenet_tpu_torch.train import optim as popt
from desenet_tpu_torch.train import schedule as psched

# a conv with bias and a BN: one parameter of each group
LEAVES = {"0.weight": ("0", "kernel"), "0.bias": ("0", "bias"),
          "1.weight": ("1", "scale"), "1.bias": ("1", "bias")}


def module():
    return nn.Sequential(nn.Conv2d(3, 4, 3, bias=True), nn.BatchNorm2d(4))


def arrays(seed, positive=False):
    rng = np.random.default_rng(seed)
    out = {}
    for name, p in module().named_parameters():
        a = rng.standard_normal(tuple(p.shape)).astype(np.float32)
        out[name] = np.abs(a) * 1e-2 if positive else a
    return out


def to_jax(d):
    tree = {}
    for name, (mod, leaf) in LEAVES.items():
        tree.setdefault(mod, {})[leaf] = jnp.asarray(d[name])
    return tree


def from_jax(tree):
    return {name: np.asarray(tree[mod][leaf])
            for name, (mod, leaf) in LEAVES.items()}


def close(got, want, bar=1e-6):
    for k in want:
        g = got[k].detach().numpy() if torch.is_tensor(got[k]) else got[k]
        scale = max(np.abs(want[k]).max(), 1e-30)
        assert np.abs(g - want[k]).max() <= bar * scale, k


def test_group_tags_match_jax():
    tags = popt.build_groups(module(), [n for n, _ in
                                        module().named_parameters()])
    jtags = from_jax(jopt.build_group_tree(to_jax(arrays(0))))
    assert tags == {k: int(v) for k, v in jtags.items()}
    assert sorted(tags.values()) == [popt.BN_WEIGHT, popt.WEIGHT,
                                     popt.BIAS, popt.BIAS]


@pytest.mark.parametrize("opt", ["sgd", "sgd_plain", "adam"])
@pytest.mark.parametrize("ni", [0, 3, 20])
def test_apply_updates_matches_jax(opt, ni):
    """From non-zero buffers, inside the warmup (ni 0, 3 of 8) and after."""
    kw = dict(optimizer="adam" if opt == "adam" else "sgd", lr0=0.02,
              nesterov=opt != "sgd_plain")
    jcfg, pcfg = jopt.OptimConfig(**kw), popt.OptimConfig(**kw)
    params, grads, mu = arrays(1), arrays(2), arrays(3)
    nu = arrays(4, positive=True)
    lr_scale = psched.one_cycle(1, 0.2, 10)(np.float32(ni // 4))
    warmup_t = np.clip(np.float32(ni) / np.float32(8), 0.0, 1.0)

    jstate = {"mu": to_jax(mu)}
    pstate = {"mu": {k: torch.from_numpy(v.copy()) for k, v in mu.items()}}
    if opt == "adam":
        jstate.update(nu=to_jax(nu), count=jnp.int32(ni))
        pstate.update(nu={k: torch.from_numpy(v.copy())
                          for k, v in nu.items()}, count=ni)
    jp, jst = jopt.apply_updates(
        to_jax(params), to_jax(grads), jstate,
        jopt.build_group_tree(to_jax(params)), jcfg,
        jsched.one_cycle(1, 0.2, 10)(jnp.float32(ni // 4)),
        jnp.float32(warmup_t))
    pp = {k: torch.from_numpy(v.copy()) for k, v in params.items()}
    groups = popt.build_groups(module(), pp)
    popt.apply_updates(pp, {k: torch.from_numpy(v) for k, v in grads.items()},
                       pstate, groups, pcfg, lr_scale, warmup_t)
    close(pp, from_jax(jp))
    close(pstate["mu"], from_jax(jst["mu"]))
    if opt == "adam":
        close(pstate["nu"], from_jax(jst["nu"]))
        assert pstate["count"] == int(jst["count"]) == ni + 1


def test_missing_gradient_counts_as_zero():
    """A frozen parameter (grad None) still moves its momentum buffer by the
    weight decay, as the JAX step's zeroed gradient does."""
    cfg = popt.OptimConfig()
    params = {k: torch.from_numpy(v) for k, v in arrays(1).items()}
    grads = {k: None for k in params}
    state = popt.init_opt_state(params, cfg)
    before = {k: v.clone() for k, v in params.items()}
    popt.apply_updates(params, grads, state,
                       popt.build_groups(module(), params), cfg,
                       np.float32(1.0), np.float32(1.0))
    assert torch.equal(state["mu"]["0.bias"], torch.zeros(4))
    torch.testing.assert_close(state["mu"]["0.weight"],
                               cfg.weight_decay * before["0.weight"])


@pytest.mark.parametrize("updates", [1, 7, 100, 2000, 30000])
def test_ema_matches_jax(updates):
    d = pema.ema_decay(updates)
    jd = float(jema.ema_decay(jnp.int32(updates)))
    # 1 - exp(-u / tau) in f32 on both sides; the two exps may differ by an
    # ulp of 1, which the subtraction keeps
    assert abs(float(d) - jd) <= 2 * 2.0 ** -24
    e, v = arrays(5), arrays(6)
    want = from_jax(jema.ema_update(to_jax(e), to_jax(v), jnp.int32(updates),
                                    tau=4.0))
    got = {k: torch.from_numpy(x.copy()) for k, x in e.items()}
    pema.ema_update(got, {k: torch.from_numpy(x) for k, x in v.items()},
                    updates, tau=4.0)
    close(got, want)


@pytest.mark.parametrize("x", [0, 1, 3, 7, 9])
def test_schedules_match_jax(x):
    for pf, jf in ((psched.one_cycle(1.0, 0.2, 10), jsched.one_cycle(1.0, 0.2, 10)),
                   (psched.linear_lr(0.2, 10), jsched.linear_lr(0.2, 10))):
        got = pf(np.float32(x))
        assert isinstance(got, np.float32)
        # f32 on both sides; numpy's cos and XLA's may differ by an ulp
        np.testing.assert_array_max_ulp(got, np.float32(jf(jnp.float32(x))),
                                        1)
    for nw in (0, 1, 8):
        got = psched.warmup_interp(np.float32(x), np.float32(nw), 1.0, 4.0)
        want = jsched.warmup_interp(jnp.float32(x), float(nw), 1.0, 4.0)
        assert got == np.float32(want)


def test_bn_running_variance_is_biased():
    """At n = 8 (batch 2, 2x2 maps) the running variance moves toward the
    biased batch variance, as flax's BatchNorm moves it: torch's unbiased
    one is 8/7 of it."""
    x = torch.from_numpy(np.random.default_rng(9).standard_normal(
        (2, 3, 2, 2)).astype(np.float32))
    bn = batch_norm(3).train()
    bn.running_var.fill_(0.5)
    bn.running_mean.fill_(0.25)
    y = bn(x)
    var = x.var((0, 2, 3), unbiased=False)
    mean = x.mean((0, 2, 3))
    torch.testing.assert_close(bn.running_var, 0.97 * 0.5 + 0.03 * var,
                               rtol=1e-6, atol=0)
    torch.testing.assert_close(bn.running_mean, 0.97 * 0.25 + 0.03 * mean,
                               rtol=1e-6, atol=0)
    unbiased = 0.97 * 0.5 + 0.03 * var * 8 / 7
    assert (bn.running_var - unbiased).abs().min() > 1e-4
    # the normalization itself is torch's (biased variance, eps 1e-3)
    want = (x - mean[:, None, None]) / torch.sqrt(var[:, None, None] + 1e-3)
    torch.testing.assert_close(y, want, rtol=1e-5, atol=1e-5)
    # and the flax module's own statistics agree
    import flax.linen as fnn
    m = fnn.BatchNorm(use_running_average=False, momentum=0.97,
                      epsilon=1e-3)
    v = {"params": {"scale": jnp.ones(3), "bias": jnp.zeros(3)},
         "batch_stats": {"mean": jnp.full(3, 0.25), "var": jnp.full(3, 0.5)}}
    jy, mut = m.apply(v, jnp.asarray(x.permute(0, 2, 3, 1).numpy()),
                      mutable=["batch_stats"])
    np.testing.assert_allclose(bn.running_var.numpy(),
                               np.asarray(mut["batch_stats"]["var"]),
                               rtol=1e-6)
    np.testing.assert_allclose(y.detach().permute(0, 2, 3, 1).numpy(),
                               np.asarray(jy), rtol=1e-5, atol=1e-5)


def test_bn_cumulative_average_is_torchs():
    """``momentum=None`` (torch's cumulative average, which flax does not
    have; tests calibrate BN statistics with it) keeps torch's own update."""
    x = torch.from_numpy(np.random.default_rng(10).standard_normal(
        (2, 3, 2, 2)).astype(np.float32))
    ours, theirs = batch_norm(3), torch.nn.BatchNorm2d(3, eps=1e-3)
    for bn in (ours, theirs):
        bn.momentum = None
        bn.train()(x)
    for k, v in theirs.state_dict().items():
        torch.testing.assert_close(ours.state_dict()[k], v, rtol=0, atol=0)
