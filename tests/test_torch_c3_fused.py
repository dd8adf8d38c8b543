"""Kernel K6's module (``desenet_tpu_torch/ops/c3_fused.py``), the C3 fold
and the two probe entry points, on the CPU.

(a) the port's ``c3_fused`` (its plain version on a CPU tensor) against the
    proto's ``c3_pallas`` with Pallas in interpret mode
    (``tools/proto_c3_kernel.py``, loaded by path), on the same numpy
    params: batch 2 at 16x16 and 12x20, n = 1..3 with the shortcut and a
    neck shape (C != 2c_) without it; f32 at rtol/atol 1e-4, bf16 at
    ``testing.BF16_BAR`` of the largest JAX value;
(b) the slice as a whole: forward hooks on every C3 of the tiny_psp2 port
    model with random BN statistics; ``c3_fused`` on ``fold_c3``'s params
    must reproduce each module's output, f32 at rtol/atol 1e-4 (and bf16
    at ``testing.BF16_MODULE_BAR``), and on a 1x1 map, where the module
    skips its BNs;
(c) both entry points' ``main`` on ``--device cpu`` at a tiny size.
"""

import copy
import importlib.util
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch
import yaml

from desenet_tpu_torch.models import build_model
from desenet_tpu_torch.models.layers import C3
from desenet_tpu_torch.ops import c3_fused
from desenet_tpu_torch.testing import (BF16_MODULE_BAR, C3_SERVED,
                                       check_bf16, check_close,
                                       random_c3_params, randomize_bn)
from desenet_tpu_torch.tools import probe_stem_pallas, proto_c3_kernel
from desenet_tpu_torch.utils.fold import fold_c3

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)


def load_proto():
    spec = importlib.util.spec_from_file_location(
        "proto_c3_kernel_jax", os.path.join(ROOT, "tools",
                                            "proto_c3_kernel.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def tiny_cfg():
    with open(os.path.join(HERE, "configs", "tiny_psp2.yaml")) as fh:
        return yaml.safe_load(fh)


# (H, W, C, c_, C2, n, shortcut)
JAX_CASES = [(16, 16, 32, 16, 32, 1, True),
             (16, 16, 64, 32, 64, 2, True),
             (12, 20, 32, 16, 32, 3, True),
             (12, 20, 128, 32, 64, 1, False)]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("h,w,c,c_,c2,n,shortcut", JAX_CASES)
def test_c3_fused_matches_the_jax_kernel(h, w, c, c_, c2, n, shortcut,
                                         dtype):
    proto = load_proto()
    rng = np.random.default_rng(c + n)
    raw = random_c3_params(rng, c, c_, c2, n)
    x = rng.normal(size=(2, h, w, c)).astype(np.float32)
    jdt, tdt = getattr(jnp, dtype), getattr(torch, dtype)
    jp = {k: jnp.asarray(v, jdt if k.startswith("w") else jnp.float32)
          for k, v in raw.items()}
    want = np.asarray(proto.c3_pallas(jnp.asarray(x, jdt), jp, n, shortcut,
                                      interpret=True), np.float32)
    got = c3_fused.c3_fused(torch.from_numpy(x).to(tdt),
                            c3_fused.c3_params(raw, "cpu", tdt), n, shortcut)
    assert got.shape == (2, h, w, c2) and got.dtype == tdt
    check_close(got, torch.tensor(want), "K6 vs JAX", 1e-4)


@pytest.fixture(scope="module")
def tiny_c3s():
    """Every C3 of the tiny_psp2 port model (random BN statistics) with the
    input and output it saw on a seeded 64x64 batch, f32."""
    model, _ = build_model(tiny_cfg())
    randomize_bn(model, seed=0)
    seen = {}
    hooks = [m.register_forward_hook(
        lambda mod, args, out, i=i: seen.__setitem__(i, (args[0], out)))
        for i, m in enumerate(model.model) if isinstance(m, C3)]
    x = torch.rand((2, 3, 64, 64), generator=torch.Generator().manual_seed(1))
    with torch.no_grad():
        model(x)
    for h in hooks:
        h.remove()
    return model, seen


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("row", [r[0] for r in C3_SERVED])
def test_fold_c3_reproduces_every_c3_of_the_model(tiny_c3s, row, dtype):
    model, seen = tiny_c3s
    m = model.model[row]
    inp, out = seen[row]
    params = c3_fused.c3_params(fold_c3(m, tuple(inp.shape[2:])), "cpu",
                                dtype)
    got = c3_fused.c3_fused(inp.permute(0, 2, 3, 1).to(dtype), params,
                            len(m.m), m.m[0].add)
    if dtype == torch.float32:
        np.testing.assert_allclose(got.numpy(),
                                   out.permute(0, 2, 3, 1).numpy(),
                                   rtol=1e-4, atol=1e-4)
    else:
        with torch.no_grad():
            want = copy.deepcopy(m).to(dtype)(inp.to(dtype))
        check_bf16(got, want.permute(0, 2, 3, 1), f"K6 row {row} vs the "
                   "module", BF16_MODULE_BAR)


def test_fold_c3_on_a_1x1_map_skips_bn():
    m = randomize_bn(C3(64, 64, 2, True).eval(), seed=3)
    x = torch.randn((2, 64, 1, 1), generator=torch.Generator().manual_seed(4))
    with torch.no_grad():
        want = m(x).permute(0, 2, 3, 1)
    params = c3_fused.c3_params(fold_c3(m, (1, 1)), "cpu", torch.float32)
    got = c3_fused.c3_fused(x.permute(0, 2, 3, 1).contiguous(), params, 2,
                            True)
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=1e-4,
                               atol=1e-4)
    folded_bn = c3_fused.c3_params(fold_c3(m, (2, 2)), "cpu", torch.float32)
    assert not torch.allclose(folded_bn["w12"], params["w12"])


@pytest.mark.parametrize("tool", [probe_stem_pallas, proto_c3_kernel])
def test_entry_points_run_on_the_cpu(tool, capsys):
    assert tool.main(["--device", "cpu", "--batch", "2", "--imgsz", "64"]) == 0
    out = capsys.readouterr().out
    assert "parity" in out and "timing" not in out
    for dt in ("torch.float32", "torch.bfloat16"):
        assert dt in out


def test_pick_tile_fits_every_served_shape():
    for _, c, c2, c_, n, _, side in C3_SERVED:
        for itemsize in (2, 4):  # the CUDA-core kernel's square tile
            t = c3_fused.pick_square_tile(c_, n, itemsize)
            assert 2 * (t + 2 * n) ** 2 * c_ * itemsize <= \
                c3_fused.SMEM_BUDGET
        th, tw = c3_fused.pick_tile(side, side, c, c_, c2, n)
        assert c3_fused.mma_smem_bytes(th, tw, c_, n) <= c3_fused.SMEM_BLOCK
    assert c3_fused.pick_square_tile(32, 1, 2) == 16
    with pytest.raises(ValueError, match="shared memory"):
        c3_fused.pick_square_tile(2048, 3, 4)
    with pytest.raises(ValueError, match="shared memory"):
        c3_fused.pick_tile(20, 20, 8192, 4096, 8192, 3)


def test_c3_fused_refuses_what_it_does_not_take():
    raw = random_c3_params(np.random.default_rng(9), 16, 8, 16, 1)
    p = c3_fused.c3_params(raw, "cpu", torch.float32)
    x = torch.zeros((1, 4, 4, 16))
    with pytest.raises(TypeError, match="float32 or bfloat16"):
        c3_fused.c3_fused(x.double(), p, 1)
    with pytest.raises(ValueError, match="NHWC"):
        c3_fused.c3_fused(x[0], p, 1)
    with pytest.raises(ValueError, match="wb1"):
        c3_fused.c3_fused(x, p, 2)
    with pytest.raises(ValueError, match="w12"):
        c3_fused.c3_fused(torch.zeros((1, 4, 4, 24)), p, 1)
    with pytest.raises(ValueError, match="CPU or CUDA"):
        c3_fused.c3_fused(x.to("meta"), {k: v.to("meta")
                                         for k, v in p.items()}, 1)
    odd = c3_fused.c3_params(random_c3_params(np.random.default_rng(9), 12,
                                              8, 16, 1))
    with pytest.raises(ValueError, match="multiples of 8"):
        c3_fused.c3_fused(torch.zeros((1, 4, 4, 12)), odd, 1)
