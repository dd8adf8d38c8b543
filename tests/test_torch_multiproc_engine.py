"""Multi-process training through the port's CLI, on the CPU (gloo).

Two processes of ``desenet_tpu_torch.cli.train`` launched through the JAX
package's environment (``DESENET_COORDINATOR``, ``DESENET_NUM_PROCESSES``,
``DESENET_PROCESS_ID``), each with its own ``--project``, against one
process on the same global batch of 8: the final weights digest (parameters,
BN statistics, EMA) and the ``results.csv`` rows agree, both processes
report process 0's fitness, and only process 0 wrote anything. The even
case (16 images, ranks of 8) and the uneven one (23 images: ranks of 12
and 11, 2 steps an epoch on both, the long rank's spare batch left), as
``tests/test_multihost_engine.py:80, 197`` run them for the JAX package.
Then ``--n-devices 2`` (the CLI starts the processes itself) against the
environment launch, and ``tools/dryrun_multichip.py`` with two processes.
"""

import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from desenet_tpu_torch.cli import train as cli_train
from desenet_tpu_torch.parallel.multihost import free_port
from desenet_tpu_torch.tools.make_fake_dataset import generate
from desenet_tpu_torch.utils.checkpoint import load_checkpoint

HERE = os.path.dirname(os.path.abspath(__file__))
REPO = os.path.dirname(HERE)
TINY_CFG = os.path.join(HERE, "configs", "tiny_psp2.yaml")
ENV = dict(os.environ, PYTHONPATH=REPO, OMP_NUM_THREADS="1")


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def cli_args(data_yaml: str, project: str) -> list:
    return ["--data", data_yaml, "--cfg", TINY_CFG, "--epochs", "2",
            "--batch-size", "8", "--img-size", "64", "--workers", "2",
            "--project", project, "--name", "mh", "--exist-ok",
            "--dtype", "float32", "--nbs", "8", "--warmup-floor", "4",
            "--noautoanchor", "--no-tb", "--max-targets", "32",
            "--patience", "10", "--seed", "0", "--device", "cpu"]


def env_launch(data_yaml: str, projects: list) -> list:
    """One cli.train process a project, joined through the environment."""
    coord = f"localhost:{free_port()}"
    procs = [subprocess.Popen(
        [sys.executable, "-m", "desenet_tpu_torch.cli.train",
         *cli_args(data_yaml, p)], cwd=REPO, stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True,
        env=dict(ENV, DESENET_COORDINATOR=coord,
                 DESENET_NUM_PROCESSES=str(len(projects)),
                 DESENET_PROCESS_ID=str(pid)))
        for pid, p in enumerate(projects)]
    outs = [p.communicate(timeout=300)[0] for p in procs]
    for p, out in zip(procs, outs):
        assert p.returncode == 0, out[-6000:]
    return outs


def digest(ckpt_dir: str) -> dict:
    payload = load_checkpoint(ckpt_dir)
    return {k: float(sum(v.double().abs().sum() for v in payload[k].values()))
            for k in ("params", "batch_stats", "ema")}


def rows(save_dir: str) -> list:
    with open(os.path.join(save_dir, "results.csv")) as f:
        lines = f.read().strip().splitlines()
    head = [h.strip() for h in lines[0].split(",")]
    return [dict(zip(head, map(float, ln.split(",")))) for ln in lines[1:]]


def best_fitness(out: str) -> float:
    line = [ln for ln in out.splitlines() if "best_fitness=" in ln][0]
    return float(line.split("best_fitness=")[1].split()[0])


def single(data_yaml: str, project: str) -> dict:
    return cli_train.main(cli_args(data_yaml, project))


@pytest.fixture(scope="module")
def roots(tmp_path_factory):
    out = {}
    for name, n, seed in (("even", 16, 11), ("uneven", 23, 13)):
        root = str(tmp_path_factory.mktemp(f"mp_{name}"))
        generate(root, n_train=n, n_val=4, size=96, seed=seed)
        out[name] = os.path.join(root, "data.yaml")
    return out


@pytest.mark.parametrize("case", ["even", "uneven"])
def test_two_processes_match_one(case, roots, tmp_path):
    data = roots[case]
    projects = [str(tmp_path / f"proj_p{pid}") for pid in range(2)]
    outs = env_launch(data, projects)
    sd0 = os.path.join(projects[0], "mh")
    for name in ("results.csv", "hyp.yaml", "opt.yaml", "last/meta.json",
                 "best_stripped/meta.json"):
        assert os.path.exists(os.path.join(sd0, name)), name
    assert not os.path.exists(projects[1])  # process 0 owns the artifacts
    assert all("done:" in out for out in outs)
    assert best_fitness(outs[0]) == best_fitness(outs[1])

    one = single(data, str(tmp_path / "single"))
    assert best_fitness(outs[1]) == pytest.approx(one["best_fitness"],
                                                  abs=1e-3)
    got, want = rows(sd0), rows(one["save_dir"])
    assert len(got) == len(want) == 2
    for g, w in zip(got, want):
        assert g["epoch"] == w["epoch"]
        for k in ("train/box_loss", "train/obj_loss", "train/cls_loss",
                  "train/seg_loss", "metrics/mIoU", "metrics/mAP_0.5",
                  "x/lr"):
            assert np.isclose(g[k], w[k], rtol=1e-3, atol=1e-4), (k, g, w)
    dm = digest(os.path.join(sd0, "last"))
    ds = digest(os.path.join(one["save_dir"], "last"))
    for k in dm:
        assert np.isclose(dm[k], ds[k], rtol=1e-4), (k, dm, ds)
    assert load_checkpoint(os.path.join(sd0, "last"))["counters"]["step"] \
        == 4


def test_n_devices_starts_the_processes(roots, tmp_path):
    data = roots["even"]
    res = cli_train.main(cli_args(data, str(tmp_path / "spawned"))
                         + ["--n-devices", "2"])
    outs = env_launch(data, [str(tmp_path / "env0"), str(tmp_path / "env1")])
    assert res["best_fitness"] == best_fitness(outs[0])
    # the started processes run torch on all threads: sums in another order
    got = digest(os.path.join(res["save_dir"], "last"))
    want = digest(os.path.join(str(tmp_path / "env0"), "mh", "last"))
    for k in want:
        assert np.isclose(got[k], want[k], rtol=1e-6), (k, got, want)
    assert sorted(os.listdir(tmp_path / "spawned")) == ["mh"]


def test_n_devices_needs_the_cards(monkeypatch, tmp_path):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="0 CUDA card"):
        cli_train.main(["--data", "x.yaml", "--project", str(tmp_path),
                        "--n-devices", "2"])
    assert not os.listdir(tmp_path)


def test_dryrun_multichip_two_processes():
    out = subprocess.run(
        [sys.executable, "-m", "desenet_tpu_torch.tools.dryrun_multichip",
         "--nproc", "2", "--device", "cpu"], cwd=REPO, env=ENV, capture_output=True, text=True,
        timeout=300)
    assert out.returncode == 0, out.stderr[-4000:]
    last = out.stdout.strip().splitlines()[-1]
    assert last.startswith("dryrun_multichip(2): ok - loss="), last
