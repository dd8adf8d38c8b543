"""The port's tooling against the JAX package's, on the CPU:

- ``utils/general.py``'s additions (``one_cycle_np``, ``check_suffix``,
  ``check_file``, ``check_yaml``, ``user_config_dir``, ``Timeout``,
  ``try_except``, ``apply_classifier``, ``attempt_download``,
  ``print_mutation``, ``check_environment``, ``set_matmul_precision``) on
  the same inputs: the same values, files and refusals (the JAX package
  asserts where the port raises ValueError);
- ``cli.sweep``: ``--print-config`` equal, ``_sample_hyp`` equal from one
  numpy seed, and a local sweep of 2 trials of the tiny config on a fake
  dataset writing ``evolve.csv`` and ``hyp_evolve.yaml``;
- ``utils/profiling.py``: the parameter count of ``model_info`` equal to
  the JAX package's on the tiny config, its FLOPs equal to the sum of 2 x
  multiply-adds over the model's convolutions, ``prune`` and ``sparsity``
  equal to the JAX package's on the same weights, ``profile_fn``,
  ``time_fn`` and ``trace`` running.

The port's copies of ``data/converters.py``, ``data/misc_tools.py`` and
``utils/wandb_offline.py`` are held against the originals in
``tests/test_torch_host_copies.py``.
"""

import contextlib
import io
import json
import os
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import yaml
from flax import traverse_util

from desenet_tpu.cli import sweep as jax_sweep
from desenet_tpu.models import build_model as jax_build_model
from desenet_tpu.utils import general as jg
from desenet_tpu.utils import profiling as jprof
from desenet_tpu.utils.torch_convert import convert_state_dict
from desenet_tpu_torch.cli import sweep
from desenet_tpu_torch.models import build_model, init_weights
from desenet_tpu_torch.tools.make_fake_dataset import generate
from desenet_tpu_torch.utils import general as pg
from desenet_tpu_torch.utils import profiling
from desenet_tpu_torch.utils.convert import tree_from_jax
from desenet_tpu_torch.utils.general import load_yaml
from torch_detect_case import one_thread

HERE = os.path.dirname(os.path.abspath(__file__))
TINY = os.path.join(HERE, "configs", "tiny_psp2.yaml")
_threads = pytest.fixture(scope="module", autouse=True)(one_thread)


def test_one_cycle_and_small_helpers_equal(tmp_path, monkeypatch):
    for args in ((1.0, 0.2, 10), (0.1, 1.0, 7)):
        f, g = pg.one_cycle_np(*args), jg.one_cycle_np(*args)
        assert [f(x) for x in range(12)] == [g(x) for x in range(12)]
    for ok in ("a.ckpt", ["b.ckpt", "c"], "noext"):
        pg.check_suffix(ok)
        jg.check_suffix(ok)
    with pytest.raises(ValueError, match="suffix"):
        pg.check_suffix(["a.ckpt", "b.pt"])
    with pytest.raises(AssertionError):
        jg.check_suffix(["a.ckpt", "b.pt"])
    (tmp_path / "sub").mkdir()
    (tmp_path / "sub" / "cfg.yaml").write_text("a: 1\n")
    monkeypatch.chdir(tmp_path)
    for mod in (pg, jg):
        assert mod.check_file("") == ""
        assert mod.check_file("sub/cfg.yaml") == "sub/cfg.yaml"
        assert mod.check_file("cfg.yaml") == os.path.join("sub", "cfg.yaml")
        assert mod.check_yaml("cfg.yaml") == os.path.join("sub", "cfg.yaml")
        with pytest.raises(FileNotFoundError, match="offline"):
            mod.check_file("https://x/y.pt")
        assert mod.attempt_download("sub/cfg.yaml") == "sub/cfg.yaml"
        with pytest.raises(FileNotFoundError, match="wanted u"):
            mod.attempt_download("nope.pt", url="u")
    with pytest.raises(FileNotFoundError, match="not found"):
        pg.check_file("nope.yaml")
    with pytest.raises(ValueError, match="suffix"):
        pg.check_yaml("cfg.txt")
    monkeypatch.setenv("DESENET_CONFIG_DIR", str(tmp_path / "cfgdir"))
    assert pg.user_config_dir() == jg.user_config_dir() == \
        tmp_path / "cfgdir"
    assert (tmp_path / "cfgdir").is_dir()


def test_timeout_try_except_environment():
    t = time.perf_counter()
    with pg.Timeout(1):
        time.sleep(3)
    assert time.perf_counter() - t < 2.5  # cut at the alarm, swallowed
    with pytest.raises(TimeoutError, match="late"):
        with pg.Timeout(1, "late", suppress_timeout_errors=False):
            time.sleep(3)
    with pg.Timeout(0):  # disabled
        pass

    @pg.try_except
    def boom():
        raise RuntimeError("x")

    assert boom() is None
    info = pg.check_environment()
    assert info["torch"] == torch.__version__ and isinstance(
        info["devices"], list)
    with pytest.raises(ValueError, match="python"):
        pg.check_environment(min_python=(99, 0))
    before = torch.get_float32_matmul_precision()
    try:
        pg.set_matmul_precision("highest")
        assert torch.get_float32_matmul_precision() == "highest"
        assert not torch.backends.cudnn.allow_tf32
    finally:
        torch.set_float32_matmul_precision(before)
        torch.backends.cudnn.allow_tf32 = True


def test_apply_classifier_equal():
    rng = np.random.default_rng(0)
    im0 = rng.integers(0, 256, (120, 160, 3)).astype(np.uint8)
    xy = rng.uniform(0, 120, (6, 2))
    boxes = np.concatenate([xy, xy + rng.uniform(5, 40, (6, 2))], 1)
    classes = rng.integers(0, 3, 6)

    def classifier(x):  # NHWC RGB 0-1 crops -> scores of 3 classes
        m = x.mean((1, 2))
        return np.stack([m[:, 0], m[:, 1], m[:, 2]], 1)

    got = pg.apply_classifier(boxes, classes, im0, classifier, size=32)
    want = jg.apply_classifier(boxes, classes, im0, classifier, size=32)
    assert got.dtype == bool and np.array_equal(got, want)
    assert pg.apply_classifier(np.zeros((0, 4)), [], im0, classifier).size \
        == 0


def test_print_mutation_equal(tmp_path):
    rng = np.random.default_rng(1)
    hyps = [{"lr0": float(rng.uniform(1e-5, 0.1)), "momentum": 0.9,
             "mosaic": float(rng.uniform())} for _ in range(3)]
    for i, h in enumerate(hyps):
        res = {"fitness": float(rng.uniform())}
        pg.print_mutation(res, h, str(tmp_path / "port"))
        jg.print_mutation(res, h, str(tmp_path / "jax"))
    for name in ("port", "jax"):
        assert (tmp_path / name / "evolve.csv").read_text().count("\n") == 4
    assert (tmp_path / "port" / "evolve.csv").read_bytes() == \
        (tmp_path / "jax" / "evolve.csv").read_bytes()
    port_yaml = str(tmp_path / "port" / "hyp_evolve.yaml")
    jax_yaml = str(tmp_path / "jax" / "hyp_evolve.yaml")
    with open(port_yaml) as f:
        head = f.readline()
    assert head.startswith("# best of 3 generations (fitness=")
    best = load_yaml(port_yaml)  # JSON after the comment: no PyYAML
    assert best == yaml.safe_load(open(port_yaml)) == load_yaml(jax_yaml)
    assert set(best) == set(hyps[0])


def test_sweep_print_config_and_sampling_equal():
    outs = []
    for mod in (sweep, jax_sweep):
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            mod.main(["--print-config"])
        outs.append(json.loads(buf.getvalue()))
    assert outs[0] == outs[1] and outs[0]["method"] == "random"
    for seed in (0, 3):
        a, b = np.random.default_rng(seed), np.random.default_rng(seed)
        for _ in range(4):
            assert sweep._sample_hyp(a) == jax_sweep._sample_hyp(b)


def test_local_sweep_writes_evolution_files(tmp_path):
    data = generate(str(tmp_path / "fk"), n_train=2, n_val=1, size=64,
                    seed=0)
    project = str(tmp_path / "sweep")
    kw = {"nbs": 2, "warmup_floor": 2, "noautoanchor": True,
          "dtype": "float32", "workers": 1}
    best = sweep.main(["--local", "2", "--data", data, "--cfg", TINY,
                       "--epochs", "1", "--batch-size", "2", "--img-size",
                       "64", "--project", project, "--device", "cpu",
                       "--train-kwargs", json.dumps(kw)])
    with open(os.path.join(project, "evolve.csv")) as f:
        rows = f.read().strip().splitlines()
    assert len(rows) == 3 and rows[0].startswith("fitness,lr0,")
    evolved = load_yaml(os.path.join(project, "hyp_evolve.yaml"))
    assert set(evolved) == set(sweep.DEFAULT_HYP)
    # each trial trained on its own drawn hyp
    rng = np.random.default_rng(0)
    for i in range(2):
        drawn = sweep._sample_hyp(rng)
        assert load_yaml(os.path.join(project, f"trial{i}_hyp.yaml")) == \
            drawn
        assert load_yaml(os.path.join(project, f"trial{i}", "hyp.yaml")) \
            == drawn
    assert best[1] is not None


def _conv_flops(model, x):
    """2 x multiply-adds of every convolution of one forward (hooks)."""
    total = []

    def hook(m, inp, out):
        k = m.weight.shape[1] * m.weight.shape[2] * m.weight.shape[3]
        total.append(2 * out.numel() * k)

    hs = [m.register_forward_hook(hook) for m in model.modules()
          if isinstance(m, torch.nn.Conv2d)]
    with torch.no_grad():
        model(x)
    for h in hs:
        h.remove()
    return sum(total)


@pytest.fixture(scope="module")
def tiny():
    """The tiny model with seeded weights, and the JAX variables of the
    same weights."""
    model, spec = build_model(yaml.safe_load(open(TINY)))
    init_weights(model, torch.Generator().manual_seed(0))
    jmodel, jspec = jax_build_model(yaml.safe_load(open(TINY)),
                                    fused_csp=False)
    shapes = jax.eval_shape(
        lambda: jmodel.init({"params": jax.random.PRNGKey(0),
                             "dropout": jax.random.PRNGKey(0)},
                            jnp.zeros((1, 64, 64, 3)), train=False))
    template = jax.tree.map(lambda s: np.zeros(s.shape, s.dtype), shapes)
    sd = {k: v.numpy() for k, v in model.state_dict().items()}
    variables, _ = convert_state_dict(sd, template, jspec)
    return model.eval(), jmodel, variables


def test_model_info_params_and_flops(tiny):
    model, jmodel, variables = tiny
    with contextlib.redirect_stdout(io.StringIO()):
        got = profiling.model_info(model, 64)
        want = jprof.model_info(jmodel, variables, 64)
    assert got["params"] == want["params"]
    x = torch.zeros(1, 3, 64, 64)
    assert got["gflops"] * 1e9 == _conv_flops(model, x)
    assert profiling.count_params(model) == got["params"]


def test_prune_and_sparsity_equal(tiny):
    """The JAX model is built with separate C3 ``cv1``/``cv2`` kernels
    (``fused_csp=False``, as its training does): prune thresholds each
    kernel, so the kernels must be the port's."""
    model, jmodel, variables = tiny
    skip = set(model.quirk_bn_keys())
    params = {k: v.detach() for k, v in model.named_parameters()
              if k not in skip}
    for amount in (0.0, 0.3, 0.7):
        pruned = profiling.prune(params, amount)
        jpruned = jprof.prune(variables["params"], amount)
        assert profiling.sparsity(pruned) == pytest.approx(
            jprof.sparsity(jpruned), abs=1e-12)
        want = tree_from_jax(traverse_util.flatten_dict(jpruned, sep="/"),
                             model.spec)
        convs = [k for k in params if params[k].dim() == 4]
        assert len(convs) > 20
        for k in params:
            assert torch.equal(pruned[k], want[k]), (amount, k)
        if amount:
            assert all((pruned[k] == 0).any() for k in convs)


def test_profile_fn_time_fn_and_trace(tmp_path):
    conv = torch.nn.Conv2d(8, 16, 3, padding=1)
    x = torch.randn(2, 8, 16, 16)
    out = profiling.profile_fn(conv, x, iters=2, with_grad=True)
    assert set(out) == {"forward_ms", "gflops", "backward_ms"}
    assert out["gflops"] * 1e9 == 2 * 2 * 16 * 16 * 16 * 8 * 9
    assert conv.weight.grad is not None
    assert profiling.time_fn(conv, x, iters=2) > 0
    with contextlib.redirect_stdout(io.StringIO()):
        with profiling.Profile("p") as p:
            conv(x)
    assert p.t > 0
    with profiling.trace(str(tmp_path / "trace")):
        conv(x)
    with open(tmp_path / "trace" / "trace.json") as f:
        assert json.load(f)["traceEvents"]
