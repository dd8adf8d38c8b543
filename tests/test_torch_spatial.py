"""The data x spatial mesh of the port (``parallel/mesh.py``,
``parallel/spatial.py``, ``--spatial``) against the JAX package's
``make_mesh(8, spatial=2)``.

Four gloo processes on the CPU (``tests/torch_spatial_worker.py``), started
once for the module while the JAX side compiles:

- each spatial primitive and band op, forward and backward, against the
  op on the whole map, on ``dp1 x sp4`` (uneven bands, a halo wider than
  a band) and ``dp2 x sp2``, in float64: the halos, gathers, convs, max
  pools and BN exactly (1e-12); the resizes and adaptive pools to 1e-6
  (their band matrices are ``resize.py``'s f32 ones);
- tiny_psp2's f32 eval forward at 128 px under ``dp2 x sp2`` against
  JAX's under ``make_mesh(8, spatial=2)`` on the same weights (JAX's
  ``init_model``, as ``tests/test_parallel.py`` takes them), to its 2e-5;
  and in float64 on the served weights of ``torch_detect_case`` (BN
  statistics from data: features that vary across the map, on which the
  two packages' own forwards differ by 2e-4) against the port's forward
  of the whole images, to 1e-6 (the band resizes' f32 matrices); and in
  f32 with the seg head as kernel K4 (its plain version here), which
  takes the gathered maps, against K4 on the whole images, to 2e-5;
- one float64 training step of a global batch of 8 at 128 px under
  ``dp2 x sp2`` against JAX's float64 step under ``make_mesh(8,
  spatial=2)`` from one state (``tests/torch_train_case.py``), to
  ``testing``'s float64 bars; every rank holds one state.

Then the mesh's layout and checks without processes, and ``cli.train
--spatial 2 --n-devices 2 --device cpu`` end to end (two processes), with
64 px refused before any process starts (``tests/test_engine.py``'s
``test_train_spatial_partitioned``).
"""

import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_detect_case as D
import torch_train_case as C
from flax import traverse_util

from desenet_tpu.models import build_model as jax_build_model
from desenet_tpu.models import init_model
from desenet_tpu.parallel import make_mesh as jax_make_mesh
from desenet_tpu.parallel import shard_batch as jax_shard_batch
from desenet_tpu.parallel.mesh import replicate_tree, spatial_sharding
from desenet_tpu_torch.models import build_model
from desenet_tpu_torch.parallel import mesh as M
from desenet_tpu_torch.parallel.multihost import free_port
from desenet_tpu_torch.testing import train_batch
from desenet_tpu_torch.utils.convert import state_dict_from_jax

HERE = os.path.dirname(os.path.abspath(__file__))
REPO = os.path.dirname(HERE)
NPROC, S, B = 4, 128, 8
EXACT = ("halo", "halo_wide", "gather_rows", "conv3", "conv3_s2",
         "conv6_s2_stem", "conv3_dilated3", "conv5", "max_pool13",
         "max_pool5", "batch_norm")
MATRIX = ("global_pool", "bins6", "bins3", "up2", "up4", "pool_up")


def step_batch():
    """``testing.train_batch`` at 128 px, int32 seg labels with ignore
    pixels across the band boundary of image 1 and inside image 6."""
    b = train_batch(np.random.default_rng(3), B, S, nc=3, max_targets=8)
    seg = b["seg_labels"].astype(np.int32)
    seg[1, 56:72] = -1
    seg[6, 10:40, 20:90] = -1
    return {**b, "seg_labels": seg}


def launch(case: dict, tmp_path):
    """Start the workers on ``case``; returns a function that waits for
    them and loads each rank's results."""
    case_path, out = str(tmp_path / "case.pt"), str(tmp_path / "out.pt")
    torch.save(case, case_path)
    coord = f"localhost:{free_port()}"
    env = dict(os.environ, PYTHONPATH=os.pathsep.join([REPO, HERE]),
               OMP_NUM_THREADS="1")
    procs = [subprocess.Popen(
        [sys.executable, os.path.join(HERE, "torch_spatial_worker.py"),
         coord, str(NPROC), str(r), case_path, out], env=env, cwd=REPO,
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for r in range(NPROC)]

    def wait():
        logs = [p.communicate(timeout=300)[0] for p in procs]
        for p, log in zip(procs, logs):
            assert p.returncode == 0, log[-4000:]
        return [torch.load(f"{out}.{r}", weights_only=False)
                for r in range(NPROC)]

    return wait


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    batch = step_batch()
    with jax.enable_x64(True):
        c = C.setup(fused=True, adam=False, accum=False, b=B)
    jmodel, _ = jax_build_model(C.tiny_cfg())
    variables = jax.device_get(init_model(jmodel, jax.random.PRNGKey(0),
                                          img_size=64, batch=1))
    sd, _ = state_dict_from_jax(
        traverse_util.flatten_dict(variables, sep="/"),
        build_model(C.tiny_cfg())[1])
    imgs = np.random.default_rng(5).uniform(0, 1, (4, S, S, 3)).astype(
        np.float32)
    wait = launch(dict(cfg=c["cfg"], fused=True, opt=c["opt"],
                       common=c["common"], jstate=c["jstate"], batch=batch,
                       anchors=C.ANCHORS, eval_images=imgs,
                       eval_sd={k: v.numpy() for k, v in sd.items()},
                       served_sd=D.member_weights(0)),
                  tmp_path_factory.mktemp("spatial"))

    mesh = jax_make_mesh(8, spatial=2)
    # JAX's eval forward under the 4 x 2 mesh (tests/test_parallel.py)
    fwd = jax.jit(lambda v, x: (lambda o: (o[0][0], o[1]))(
        jmodel.apply(v, x, train=False)))
    dec, seg = fwd(replicate_tree(variables, mesh),
                   jax.device_put(jnp.asarray(imgs), spatial_sharding(mesh)))
    want_fwd = (np.asarray(dec), np.asarray(seg))
    with jax.enable_x64(True):
        # JAX's float64 step under the 4 x 2 mesh
        jst = replicate_tree(c["jst"], mesh)
        jst, jm = c["jstep"](jst, jax_shard_batch(batch, mesh),
                             jax.random.PRNGKey(0))
        want_step = ({k: float(v) for k, v in jm.items()},
                     C.jax_snapshot(jst, c["spec"], False))
    return want_fwd, want_step, wait()


@pytest.mark.parametrize("name", EXACT + MATRIX)
@pytest.mark.parametrize("tag", ["dp1xsp4", "dp2xsp2"])
def test_primitive_matches_whole_map(runs, name, tag):
    bar = 1e-12 if name in EXACT else 1e-6
    for rank, out in enumerate(runs[2]):
        fwd, grad = out["primitives"][f"{name}/{tag}"]
        assert fwd <= bar and grad <= bar, (rank, fwd, grad)


def test_eval_forward_matches_jax_mesh(runs):
    (dec, seg), _, got = runs
    seen = set()
    for out in got:
        f = out["forward"]
        assert f["band"] == (2, 64, S, 3)  # 2 images, half of each
        for i, row in enumerate(f["rows"]):
            np.testing.assert_allclose(f["dec"][i], dec[row], rtol=2e-5,
                                       atol=2e-5)
            np.testing.assert_allclose(f["seg"][i], seg[row], rtol=2e-5,
                                       atol=2e-5)
            seen.add(row)
    assert seen == {0, 1, 2, 3}


def test_eval_forward_is_the_whole_images_forward(runs):
    for out in runs[2]:
        f = out["forward64"]
        for k in ("dec", "seg"):
            err = np.abs(f[k] - f[f"{k}_whole"]).max()
            assert err <= 1e-6 * max(1.0, np.abs(f[f"{k}_whole"]).max()), (
                k, err)


def test_eval_forward_k4_takes_whole_maps(runs):
    """``seg_head_fused`` under a scope: K4 runs once on the gathered
    maps, and its output is the whole images' K4 output (2e-5, as the
    forward against JAX)."""
    for out in runs[2]:
        f = out["forward_k4"]
        assert f["k4_calls"] == 1
        for k in ("dec", "seg"):
            np.testing.assert_allclose(f[k], f[f"{k}_whole"], rtol=2e-5,
                                       atol=2e-5)


@pytest.mark.parametrize("what", C.CHECKS)
def test_step_matches_jax_mesh(runs, what):
    _, (jm, js), got = runs
    pm, ps = got[0]["step"]
    C.check((jm, pm, js, ps), what, 0)
    assert pm["stepped"] == 1


def test_ranks_hold_one_state(runs):
    got = runs[2]
    m0, s0 = got[0]["step"]
    for out in got[1:]:
        m, st = out["step"]
        assert m == m0 and st["counters"] == s0["counters"]
        for g in ("params", "stats", "mu", "ema"):
            for k, v in s0[g].items():
                torch.testing.assert_close(st[g][k], v, rtol=0, atol=1e-12)


def test_make_mesh_layout():
    """Without a process group a mesh is its layout: JAX's axis names and
    shape, this process at the origin; the JAX message for a count the
    spatial factor does not divide."""
    m = M.make_mesh(8, spatial=2)
    assert m.shape == {"data": 4, M.SPATIAL_AXIS: 2}
    assert m.axis_names == jax_make_mesh(8, spatial=2).axis_names
    assert M.make_mesh(8).shape == {"data": 8}
    assert (m.data_index, m.spatial_index) == (0, 0)
    with pytest.raises(ValueError, match="not divisible by spatial=3"):
        M.make_mesh(8, spatial=3)


def test_check_spatial_rejects_below_two_rows():
    M.check_spatial(M.make_mesh(8, spatial=2), 128)
    M.check_spatial(M.make_mesh(8), 32)  # no spatial axis: nothing to hold
    with pytest.raises(ValueError, match="below"):
        M.check_spatial(M.make_mesh(8, spatial=2), 64)


@pytest.mark.parametrize("height, counts", [(128, (2, 2)), (672, (11, 10)),
                                            (224, (4, 3))])
def test_band_split_takes_whole_strides(height, counts):
    assert M.band_counts(height, 2) == counts
    rows = [M.band_rows(height, 2, i) for i in range(2)]
    assert rows[0].start == 0 and rows[0].stop == rows[1].start
    assert rows[1].stop == height and rows[1].start % 32 == 0


def test_shard_batch_and_padding():
    """Data rows, then the height band of image and seg_labels only;
    padding to the data axis repeats the last element."""
    b = {"image": np.arange(8 * 64 * 4 * 3).reshape(8, 64, 4, 3),
         "seg_labels": np.zeros((8, 64, 4)), "det_mask": np.ones((8, 5))}
    mesh = M.Mesh(4, 2, data_index=3, spatial_index=1)
    got = M.shard_batch(b, mesh)
    assert got["image"].shape == (2, 32, 4, 3)
    np.testing.assert_array_equal(got["image"], b["image"][6:8, 32:64])
    assert got["seg_labels"].shape == (2, 32, 4)
    assert got["det_mask"].shape == (2, 5)
    padded, n = M.pad_batch_for_mesh({k: v[:6] for k, v in b.items()},
                                     M.Mesh(4, 1))
    assert n == 6 and padded["image"].shape[0] == 8
    np.testing.assert_array_equal(padded["image"][7], b["image"][5])


def test_cli_train_spatial(tmp_path):
    """``--spatial 2 --n-devices 2 --device cpu``: one epoch to finite
    losses at 128 px; 64 px refused before the processes start."""
    from desenet_tpu_torch.cli import train as cli_train
    from desenet_tpu_torch.tools.make_fake_dataset import main as make_fake

    make_fake([str(tmp_path / "ds"), "--n-train", "2", "--n-val", "1",
               "--size", "128"])
    argv = ["--data", str(tmp_path / "ds" / "data.yaml"), "--cfg",
            os.path.join(HERE, "configs", "tiny_psp2.yaml"), "--epochs", "1",
            "--batch-size", "2", "--img-size", "128", "--dtype", "float32",
            "--nbs", "2", "--warmup-floor", "2", "--device", "cpu",
            "--no-tb", "--noautoanchor", "--workers", "1", "--project",
            str(tmp_path / "runs"), "--n-devices", "2", "--spatial", "2"]
    res = cli_train.main(argv)
    with open(os.path.join(res["save_dir"], "results.csv")) as f:
        lines = f.read().strip().splitlines()
    assert len(lines) == 2
    vals = [v for v in lines[-1].split(",") if v != ""]
    assert all(np.isfinite(float(v)) for v in vals)
    with pytest.raises(ValueError, match="below"):
        cli_train.main(argv[:argv.index("--img-size") + 1] + ["64"]
                       + argv[argv.index("--img-size") + 2:])


def test_spatial_process_conditions():
    """The batch divides over the data axis only; the spatial factor must
    divide the process count (the JAX engine's messages)."""
    from desenet_tpu_torch.train import engine

    engine.check_processes(engine.TrainConfig(batch_size=2, spatial=2), 4)
    with pytest.raises(ValueError, match="--spatial 2 must divide"):
        engine.check_processes(engine.TrainConfig(batch_size=2, spatial=2), 3)
    with pytest.raises(ValueError, match="not divisible by 2"):
        engine.check_processes(engine.TrainConfig(batch_size=3, spatial=2), 4)


def test_reenter_carries_a_scope_to_another_thread():
    """A recompute on autograd's device thread starts with no scope;
    ``reenter`` gives it the one its forward ran in (``layers.checkpointed``
    captures it)."""
    import threading

    from desenet_tpu_torch.parallel import spatial

    ctx = spatial.SpatialCtx(M.Mesh(1, 2, spatial_group=object()), (2, 2))
    seen = []
    with spatial.reenter(ctx):
        assert spatial.current() is ctx
        t = threading.Thread(target=lambda: seen.append(spatial.current()))
        t.start()
        t.join(timeout=10)

        def inner():
            with spatial.reenter(ctx):
                seen.append(spatial.current())

        t = threading.Thread(target=inner)
        t.start()
        t.join(timeout=10)
    assert not t.is_alive() and seen == [None, ctx]
    assert spatial.current() is None


def test_spatial_across_hosts_raises(monkeypatch):
    """As the JAX engine's multi-process runs keep to spatial 1, the
    port's spatial runs keep to one host."""
    from desenet_tpu_torch.parallel import multihost
    from desenet_tpu_torch.train import engine

    monkeypatch.setattr(multihost, "host_count", lambda: 2)
    with pytest.raises(ValueError, match="spatial=1 only"):
        engine.make_run_mesh(engine.TrainConfig(spatial=2), 2)
    assert engine.make_run_mesh(engine.TrainConfig(), 1).shape == {"data": 1}
