"""Multi-device inference of the port (``Predictor(n_devices=N)``) against
one device and against the JAX package's ``Predictor(n_devices=8)`` on the
same checkpoint (``tests/test_api_multidevice.py``'s cases).

The CPU stands in for the cards as JAX's 8 virtual CPU devices do: N
replicas on the CPU, each batch padded to a multiple of N (the last image
repeated) and split a slice a replica, the padded rows dropped. Against
one device: boxes to JAX's own multi-device bars (rtol 1e-4, atol 1e-3
pixels; a slice of another batch size takes other CPU conv blockings),
masks equal. Against JAX: boxes to ``test_torch_detect``'s 1e-4 of the
native size, masks at least 99.9% equal. Then ``bake_weights=False``, the over-available
raise on the card path, and the CLI flags: ``cli.serve --n-devices`` and
``--no-bake-weights`` reach the Predictor, ``cli.val --matmul-precision``
sets TF32.
"""

import numpy as np
import pytest
import torch

import torch_detect_case as D
from desenet_tpu.api import Predictor as JaxPredictor
from desenet_tpu_torch.api import load_predictor
from desenet_tpu_torch.cli import serve as cli_serve
from desenet_tpu_torch.cli import val as cli_val

KW = dict(imgsz=64, half=False, conf_thres=1e-6, max_det=10)
TOL = 1e-4


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    yield from D.one_thread()


@pytest.fixture(scope="module")
def ckpts(tmp_path_factory):
    return D.write_checkpoints(str(tmp_path_factory.mktemp("md")), 0)


@pytest.fixture(scope="module")
def jax_multi(ckpts):
    return JaxPredictor(ckpts[0], n_devices=8, **KW)


def _imgs(n):
    rng = np.random.default_rng(5)
    return [rng.integers(0, 255, (70 + 2 * i, 90, 3), np.uint8)
            for i in range(n)]


def assert_same(got, want):
    """One device's results: tests/test_api_multidevice.py's bars."""
    assert len(got) == len(want)
    for g, w in zip(got.xyxy, want.xyxy):
        assert g.shape == w.shape
        np.testing.assert_allclose(g, w, rtol=1e-4, atol=1e-3)
    for g, w in zip(got.masks, want.masks):
        np.testing.assert_array_equal(g, w)


def assert_like_jax(got, want):
    """JAX's results: tests/test_torch_detect.py's bars."""
    assert len(got) == len(want)
    assert sum(len(d) for d in want.xyxy) > 0
    for g, w in zip(got.xyxyn, want.xyxyn):
        assert g.shape == w.shape
        np.testing.assert_array_equal(g[:, 5], w[:, 5])
        np.testing.assert_allclose(g[:, :5], w[:, :5], rtol=0, atol=TOL)
    for g, w in zip(got.masks, want.masks):
        assert g.shape == w.shape and (g == w).mean() >= 0.999


@pytest.mark.parametrize("n", [3, 8], ids=["padded", "exact_multiple"])
def test_multidevice_matches_single_and_jax(ckpts, jax_multi, n):
    """3 images pad to 8 and slice back; 8 split evenly."""
    single = load_predictor(ckpts[1], device="cpu", **KW)
    multi = load_predictor(ckpts[1], device="cpu", n_devices=8, **KW)
    assert len(multi._replicas) == 8
    imgs = _imgs(n)
    got = multi(imgs)
    assert_same(got, single(imgs))
    assert_like_jax(got, jax_multi(imgs))


def test_bake_weights_off_matches(ckpts):
    baked = load_predictor(ckpts[1], device="cpu", **KW)
    shared = load_predictor(ckpts[1], device="cpu", bake_weights=False, **KW)
    imgs = _imgs(2)
    assert_same(shared(imgs), baked(imgs))


def test_n_devices_over_available_raises(ckpts, monkeypatch):
    """More cards than visible fails before anything reaches a card."""
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 8)
    with pytest.raises(ValueError, match="devices"):
        load_predictor(ckpts[1], n_devices=16, **KW)


def test_replicas_on_named_devices(ckpts):
    """The private placement on a given device list (two replicas on one
    device, as ``chip_smoke.py`` puts two on one card)."""
    pred = load_predictor(ckpts[1], device="cpu", **KW)
    imgs = _imgs(5)
    want = pred(imgs)
    pred._place_replicas([torch.device("cpu")] * 2)
    assert len(pred._replicas) == 2
    assert_same(pred(imgs), want)


def test_serve_cli_flags_reach_predictor(ckpts, monkeypatch):
    args = cli_serve.parse_opt(["--weights", ckpts[1], "--device", "cpu",
                                "--img-size", "64", "--no-half",
                                "--n-devices", "2", "--no-bake-weights"])
    assert args.n_devices == 2 and args.no_bake_weights
    seen = {}

    def spy(weights, **kw):
        seen.update(kw)
        return load_predictor(weights, **kw)

    monkeypatch.setattr(cli_serve, "load_predictor", spy)
    pred = cli_serve.build_predictor(args)
    assert pred.n_devices == 2 and len(pred._replicas) == 2
    assert seen["n_devices"] == 2 and seen["bake_weights"] is False
    defaults = cli_serve.parse_opt(["--seed", "0"])
    assert defaults.n_devices == 1 and not defaults.no_bake_weights


def test_val_matmul_precision_sets_tf32(tmp_path):
    """``--matmul-precision highest`` turns TF32 off in cuBLAS and cuDNN
    before anything else runs (here the missing data yaml raises)."""
    o = cli_val.parse_opt(["--data", "d.yaml", "--weights", "w",
                           "--matmul-precision", "highest"])
    assert o.matmul_precision == "highest"
    assert cli_val.parse_opt(["--data", "d.yaml", "--weights", "w"]
                             ).matmul_precision == "default"
    saved = (torch.get_float32_matmul_precision(),
             torch.backends.cudnn.allow_tf32)
    try:
        torch.set_float32_matmul_precision("high")
        torch.backends.cudnn.allow_tf32 = True
        with pytest.raises(FileNotFoundError):
            cli_val.main(["--data", str(tmp_path / "missing.yaml"),
                          "--weights", "w", "--device", "cpu",
                          "--matmul-precision", "highest"])
        assert torch.get_float32_matmul_precision() == "highest"
        assert torch.backends.cudnn.allow_tf32 is False
    finally:
        torch.set_float32_matmul_precision(saved[0])
        torch.backends.cudnn.allow_tf32 = saved[1]
