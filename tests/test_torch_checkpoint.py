"""The port's checkpoints (``desenet_tpu_torch/utils/checkpoint.py``) on the
CPU: a save -> load round trip is bitwise (weights, BN statistics, EMA,
optimizer buffers, the gradients accumulated between optimizer steps,
counters) and a state restored from it takes the same next step as the one
saved; the strip keeps only the EMA; the meta.json schema is the JAX
package's plus ``format``; ``intersect_trees`` transfers by name and shape;
and a JAX (orbax) checkpoint crosses through ``train_state_from_jax`` and
resumes in the port's engine with its counters going on."""

import json
import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import traverse_util

import torch_train_case as C
from desenet_tpu.models import build_model as jax_build_model
from desenet_tpu.train import TrainState as JTrainState
from desenet_tpu.train.optim import build_group_tree
from desenet_tpu.utils import checkpoint as jax_ckpt
from desenet_tpu.utils.torch_convert import convert_state_dict
from desenet_tpu_torch.losses import DetectionLoss
from desenet_tpu_torch.models import build_model, init_weights
from desenet_tpu_torch.train import create_train_state, make_train_step
from desenet_tpu_torch.train import one_cycle
from desenet_tpu_torch.train.optim import OptimConfig
from desenet_tpu_torch.train.state import bn_stats
from desenet_tpu_torch.utils import checkpoint as ckpt
from desenet_tpu_torch.utils.convert import train_state_from_jax

HERE = os.path.dirname(os.path.abspath(__file__))
META = {"cfg": "tiny", "imgsz": 64, "de_nc": 3, "se_nc": 2,
        "de_names": ["a", "b", "c"], "se_names": ["bg", "road"],
        "hyp": {"lr0": 0.01}}


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """One intra-op thread: as fast on these tiny tensors, and the parallel
    test workers then do not oversubscribe the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def trained(adam: bool, steps: int, nominal: int):
    """The tiny model after ``steps`` steps (batch 2, nominal batch
    ``nominal``: above 2 the gradients accumulate between updates)."""
    model, _ = build_model(C.tiny_cfg(), seg_upsample=False, train=True)
    init_weights(model, torch.Generator().manual_seed(0))
    cfg = OptimConfig(optimizer="adam" if adam else "sgd", lr0=1e-3)
    state = create_train_state(model, cfg)
    step = make_train_step(model, DetectionLoss(anchors=C.ANCHORS, nc=3),
                           cfg, one_cycle(1, 0.2, 10), nb=4, warmup_iters=2,
                           nominal_bs=nominal, batch_size=2, fused_seg=True)
    for i in range(steps):
        state, _ = step(state, C.batch(i))
    return state, step, cfg


def groups(state):
    out = {"params": state.params, "batch_stats": bn_stats(state.model),
           "ema": state.ema, "mu": state.opt_state["mu"],
           "grads": {k: p.grad for k, p in state.params.items()
                     if p.grad is not None}}
    if "nu" in state.opt_state:
        out["nu"] = state.opt_state["nu"]
    return out


def assert_bitwise(a: dict, b: dict):
    assert set(a) == set(b)
    for g in a:
        assert set(a[g]) == set(b[g]), g
        for k in a[g]:
            assert torch.equal(a[g][k].detach().cpu(), b[g][k].detach().cpu()
                               ), (g, k)


@pytest.mark.parametrize("adam,steps,nominal", [(False, 3, 2), (False, 3, 8),
                                                (True, 2, 8)])
def test_round_trip_is_bitwise(tmp_path, adam, steps, nominal):
    state, step, cfg = trained(adam, steps, nominal)
    accumulating = nominal > 2
    assert any(p.grad is not None for p in state.params.values()) == \
        accumulating
    ckpt.save_checkpoint(str(tmp_path / "last"), state, 4, 0.25, META)
    payload = ckpt.load_checkpoint(str(tmp_path / "last"))
    assert payload["counters"] == {
        "ema_updates": state.ema_updates, "step": steps,
        "last_opt_step": state.last_opt_step, "epoch": 4,
        "best_fitness": 0.25}
    saved = {"params": payload["params"],
             "batch_stats": payload["batch_stats"], "ema": payload["ema"],
             "mu": payload["opt_state"]["mu"],
             "grads": payload["accum_grads"]}
    if adam:
        saved["nu"] = payload["opt_state"]["nu"]
        assert payload["opt_state"]["count"] == state.opt_state["count"]
    assert_bitwise(groups(state), saved)

    # a fresh model and state restored from it take the same next step
    fresh, fstep, _ = trained(adam, 0, nominal)
    ckpt.restore_train_state(fresh, payload)
    assert_bitwise(groups(state), groups(fresh))
    assert (fresh.step, fresh.last_opt_step, fresh.ema_updates) == \
        (state.step, state.last_opt_step, state.ema_updates)
    state, m = step(state, C.batch(9))
    fresh, fm = fstep(fresh, C.batch(9))
    assert float(m["loss"]) == float(fm["loss"])
    assert m["stepped"] == fm["stepped"]
    assert_bitwise(groups(state), groups(fresh))


def test_strip_keeps_the_ema_and_meta(tmp_path):
    state, _, _ = trained(False, 2, 2)
    ckpt.save_checkpoint(str(tmp_path / "best"), state, 1, 0.5, META)
    ckpt.strip_checkpoint(str(tmp_path / "best"), str(tmp_path / "stripped"))
    slim = ckpt.load_checkpoint(str(tmp_path / "stripped"))
    assert sorted(slim) == ["batch_stats", "meta", "params"]
    params, stats = ckpt.split_stats(state.ema)
    assert_bitwise({"p": params, "s": stats},
                   {"p": slim["params"], "s": slim["batch_stats"]})
    assert set(stats) == set(bn_stats(state.model)) and stats
    sd = ckpt.inference_state_dict(slim)
    assert set(sd) == set(state.ema)
    assert torch.equal(ckpt.inference_state_dict(
        ckpt.load_checkpoint(str(tmp_path / "best")))[next(iter(params))],
        state.ema[next(iter(params))])
    with open(tmp_path / "stripped" / "meta.json") as fh:
        meta = json.load(fh)
    assert meta == {**META, "schema_version": 3, "format": "torch",
                    "layout": {"focus": "focus", "c3": "unfused"}}


def test_meta_schema_is_the_jax_one_plus_format(tmp_path):
    """The keys of the JAX package's meta.json, and ``format``."""
    jstate = jax_state(np.random.default_rng(0))
    jax_ckpt.save_checkpoint(str(tmp_path / "jax"), jstate, 0, 0.0, META)
    state, _, _ = trained(False, 1, 2)
    ckpt.save_checkpoint(str(tmp_path / "port"), state, 0, 0.0, META)
    metas = [json.loads((tmp_path / d / "meta.json").read_text())
             for d in ("jax", "port")]
    assert set(metas[1]) == set(metas[0]) | {"format"}
    assert metas[1]["schema_version"] == metas[0]["schema_version"]
    assert set(metas[1]["layout"]) == set(metas[0]["layout"])
    with pytest.raises(FileNotFoundError, match="train_state_from_jax"):
        ckpt.load_checkpoint(str(tmp_path / "jax"))


def test_intersect_trees_by_name_and_shape():
    dst = {"a": torch.zeros(2, 3), "b": torch.zeros(4), "c": torch.zeros(1)}
    src = {"a": torch.ones(2, 3, dtype=torch.float64), "b": torch.ones(5),
           "d": torch.ones(1)}
    out, n = ckpt.intersect_trees(src, dst)
    assert n == 1 and out["a"].dtype == torch.float32
    assert torch.equal(out["a"], torch.ones(2, 3))
    assert out["b"] is dst["b"] and out["c"] is dst["c"]


def jax_state(rng):
    """A JAX TrainState of the tiny model from numpy (no JAX init runs):
    the port's seeded weights through ``convert_state_dict``, momentum and
    a perturbed EMA that are not zero, counters at 6."""
    cfg = C.tiny_cfg()
    jmodel, jspec = jax_build_model(cfg, seg_upsample=False)
    model, _ = build_model(cfg, train=True)
    init_weights(model, torch.Generator().manual_seed(1))
    template = jax.eval_shape(
        lambda: jmodel.init({"params": jax.random.PRNGKey(0),
                             "dropout": jax.random.PRNGKey(0)},
                            jnp.zeros((1, 64, 64, 3)), train=False))
    template = jax.tree.map(lambda s: np.zeros(s.shape, np.float32), template)
    variables, _ = convert_state_dict(
        {k: v.numpy() for k, v in model.state_dict().items()}, template,
        jspec)
    like = lambda t, s: jax.tree.map(  # noqa: E731
        lambda x: (rng.standard_normal(x.shape) * s).astype(np.float32), t)
    params, stats = variables["params"], variables["batch_stats"]
    dev = lambda t: jax.tree.map(jnp.asarray, t)  # noqa: E731
    return JTrainState(
        params=dev(params), batch_stats=dev(stats),
        opt_state=dev({"mu": like(params, 1e-2)}),
        accum_grads=dev(jax.tree.map(np.zeros_like, params)),
        ema_params=dev(jax.tree.map(lambda a, n: a + n, params,
                                    like(params, 1e-3))),
        ema_batch_stats=dev(stats), ema_updates=jnp.int32(6),
        step=jnp.int32(6), last_opt_step=jnp.int32(5),
        groups=build_group_tree(params))


def flat(tree):
    return {k: np.asarray(v) for k, v in
            traverse_util.flatten_dict(tree, sep="/").items()}


def test_jax_checkpoint_crosses_and_resumes(tmp_path):
    """JAX save -> JAX load -> train_state_from_jax -> the port's save ->
    the port's engine resumes it for one epoch on a fake dataset."""
    pytest.importorskip("cv2", reason="the fake dataset needs cv2")
    pytest.importorskip("PIL", reason="the loader decodes images with PIL")
    sys.path.insert(0, os.path.join(os.path.dirname(HERE), "tools"))
    from make_fake_dataset import generate

    from desenet_tpu_torch.train import engine

    jstate = jax_state(np.random.default_rng(2))
    jax_ckpt.save_checkpoint(str(tmp_path / "jax"), jstate, 2, 0.125, META)
    payload = jax_ckpt.load_checkpoint(str(tmp_path / "jax"))
    c = payload["counters"]
    crossing = {k: flat(payload[k]) for k in (
        "params", "batch_stats", "ema_params", "ema_batch_stats",
        "accum_grads")}
    crossing.update(mu=flat(payload["opt_state"]["mu"]),
                    step=int(c["step"]), ema_updates=int(c["ema_updates"]),
                    last_opt_step=int(c["last_opt_step"]))
    model, _ = build_model(C.tiny_cfg(), seg_upsample=False, train=True)
    hyp = engine.load_hyp()
    opt_cfg = engine.loss_and_schedule(hyp, model.spec, 64, 4)[1]
    state = train_state_from_jax(crossing, model, opt_cfg)
    ckpt.save_checkpoint(str(tmp_path / "port"), state, int(c["epoch"]),
                         float(c["best_fitness"]), META)
    assert_bitwise(groups(state), groups(restored(tmp_path / "port",
                                                  opt_cfg)))

    data = generate(str(tmp_path / "ds"), n_train=4, n_val=2, size=64,
                    de_nc=3, se_nc=2, seed=1)
    cfg = engine.TrainConfig(
        data=data, cfg=os.path.join(HERE, "configs", "tiny_psp2.yaml"),
        resume=str(tmp_path / "port"), epochs=4, batch_size=2, imgsz=64,
        workers=1, project=str(tmp_path / "runs"), dtype="float32", nbs=2,
        warmup_floor=2, use_tb=False, noautoanchor=True, max_targets=16,
        device="cpu")
    res = engine.train(cfg)
    with open(os.path.join(res["save_dir"], "results.csv")) as fh:
        assert [r.split(",")[0] for r in fh.read().split()[1:]] == ["3"]
    last = ckpt.load_checkpoint(os.path.join(res["save_dir"], "last"))
    assert last["counters"]["epoch"] == 3
    assert last["counters"]["step"] == 6 + 2  # two batches of 2
    assert last["counters"]["ema_updates"] == 6 + 2
    assert last["counters"]["best_fitness"] >= 0.125


def restored(path, opt_cfg):
    model, _ = build_model(C.tiny_cfg(), seg_upsample=False, train=True)
    state = create_train_state(model, opt_cfg)
    return ckpt.restore_train_state(state, ckpt.load_checkpoint(str(path)))
