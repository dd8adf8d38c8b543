"""The checkpoint schema migrations of the port
(``desenet_tpu_torch/utils/checkpoint.py``: ``migrate_focus_params``,
``migrate_unfused_c3``, ``defuse_c3``, ``migrate_legacy``,
``migrate_to_version``) against ``desenet_tpu/utils/checkpoint.py`` on
variables trees that the JAX package makes: tiny_psp2 and tiny_psp2 with
C3Ghost rows (which no C3 migration may touch), each as the current fused
tree, its unfused-C3 training layout and its v1 (unfused Focus) layout.
(The trees are laid out by the JAX model, ``jax.eval_shape`` of its
init, and filled with seeded numpy values.) Every result is compared with
the JAX function's leaf for leaf, bit for bit; each migration is
idempotent; ``migrate_to_version`` raises the JAX package's two errors;
and ``utils/convert.state_dict_from_jax`` of a v1 tree under
``schema_version=1`` (and of an unversioned one under None) equals that
of the current tree, for the port's Focus and FusedFocus stems (the
latter takes the fused kernel as it is, so there a v1 tree maps only once
migrated)."""

import copy
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import yaml
from flax import traverse_util
from test_checkpoint_schema import defuse_focus

from desenet_tpu.models import build_model as jax_build_model
from desenet_tpu.utils import checkpoint as jckpt
from desenet_tpu_torch.models import parse_config
from desenet_tpu_torch.utils import checkpoint as tckpt
from desenet_tpu_torch.utils.convert import state_dict_from_jax

HERE = os.path.dirname(os.path.abspath(__file__))
FNS = ("migrate_focus_params", "migrate_unfused_c3", "defuse_c3",
       "migrate_legacy")


def _cfg(name):
    with open(os.path.join(HERE, "configs", "tiny_psp2.yaml")) as fh:
        cfg = yaml.safe_load(fh)
    if name == "ghost":  # C3Ghost in the backbone, C3 in the neck
        cfg["backbone"][2] = [-1, 3, "C3Ghost", [128]]
        cfg["backbone"][4] = [-1, 9, "C3Ghost", [256]]
    return cfg


def jax_variables(cfg, seed: int, **kw) -> dict:
    """The JAX model's eval variables tree (``params``, ``batch_stats``)
    as ``init_model`` lays it out (by ``jax.eval_shape``: no forward),
    filled with seeded numpy values: N(0, 0.1), BN variances U(0.5, 1.5)."""
    model, _ = jax_build_model(cfg, **kw)
    key = jax.random.PRNGKey(0)
    shapes = jax.eval_shape(lambda: model.init(
        {"params": key, "dropout": key},
        jnp.zeros((1, 64, 64, 3), jnp.float32), train=False))
    rng = np.random.default_rng(seed)
    flat = {k: (rng.uniform(0.5, 1.5, s.shape) if k.endswith("/var")
                else rng.normal(0, 0.1, s.shape)).astype(s.dtype)
            for k, s in traverse_util.flatten_dict(
                {c: shapes[c] for c in ("params", "batch_stats")},
                sep="/").items()}
    return traverse_util.unflatten_dict(flat, sep="/")


@pytest.fixture(scope="module")
def trees():
    """name -> (config, {layout: variables tree of numpy arrays})."""
    out = {}
    for name in ("tiny_psp2", "ghost"):
        cur = jax_variables(_cfg(name), 3, fused_csp=True)
        unfused = jckpt.defuse_c3(copy.deepcopy(cur))
        out[name] = (_cfg(name), {"v3": cur, "unfused": unfused,
                                  "v1": defuse_focus(unfused)})
    return out


def _flat(tree):
    return traverse_util.flatten_dict(tree, sep="/")


def assert_trees_equal(got, want):
    fg, fw = _flat(got), _flat(want)
    assert sorted(fg) == sorted(fw)
    for k in fw:
        a, b = np.asarray(fg[k]), np.asarray(fw[k])
        assert a.dtype == b.dtype and a.shape == b.shape, k
        assert np.array_equal(a, b), k


CASES = [(n, lay, fn) for n in ("tiny_psp2", "ghost")
         for lay in ("v3", "unfused", "v1") for fn in FNS]


@pytest.mark.parametrize("name,layout,fn", CASES)
def test_migration_matches_jax(trees, name, layout, fn):
    tree = trees[name][1][layout]
    got = getattr(tckpt, fn)(copy.deepcopy(tree))
    want = getattr(jckpt, fn)(copy.deepcopy(tree))
    assert_trees_equal(got, want)
    assert_trees_equal(getattr(tckpt, fn)(copy.deepcopy(got)), got)
    if name == "ghost" and fn == "migrate_unfused_c3":
        # the C3Ghost rows keep cv1/cv2, the neck's C3 rows are fused
        params = got["params"]
        assert "cv1" in params["l2"] and "cv12" not in params["l2"]
        assert "cv12" in params["l13"]


@pytest.mark.parametrize("name", ["tiny_psp2", "ghost"])
@pytest.mark.parametrize("version", [1, 2, 3])
def test_migrate_to_version_matches_jax(trees, name, version):
    """A tree of each schema through the registry, as the JAX package's
    ``load_inference_variables`` takes it (the v1 and v2 trees in the
    unfused C3 layout of a training checkpoint): equal to the JAX
    result, and to the current tree once C3 is fused."""
    layouts = trees[name][1]
    tree = layouts["v1" if version == 1 else "unfused"]
    got = tckpt.migrate_to_version(copy.deepcopy(tree), version)
    assert_trees_equal(got, jckpt.migrate_to_version(copy.deepcopy(tree),
                                                     version))
    assert_trees_equal(tckpt.migrate_unfused_c3(got), layouts["v3"])


def test_migrate_to_version_errors():
    assert tckpt.SCHEMA_VERSION == jckpt.SCHEMA_VERSION == 3
    assert sorted(tckpt.MIGRATIONS) == sorted(jckpt.MIGRATIONS)
    for mod in (tckpt, jckpt):
        with pytest.raises(ValueError, match="newer than this code"):
            mod.migrate_to_version({"params": {}}, mod.SCHEMA_VERSION + 1)
        with pytest.raises(ValueError,
                           match="no migration registered for schema v0"):
            mod.migrate_to_version({"params": {}}, 0)


@pytest.mark.parametrize("name", ["tiny_psp2", "ghost"])
@pytest.mark.parametrize("layout,version", [("v1", 1), ("unfused", 2),
                                            ("v1", None), ("unfused", None)])
@pytest.mark.parametrize("fuse_focus", [False, True])
def test_state_dict_from_jax_takes_a_version(trees, name, layout, version,
                                             fuse_focus):
    cfg, layouts = trees[name]
    spec = parse_config(cfg, fuse_focus=fuse_focus)
    want, want_unfilled = state_dict_from_jax(_flat(layouts["v3"]), spec)
    got, unfilled = state_dict_from_jax(_flat(layouts[layout]), spec,
                                        schema_version=version)
    assert unfilled == want_unfilled and sorted(got) == sorted(want)
    for k in want:
        assert torch.equal(got[k], want[k]), k
    # today's callers pass no version: the current tree as it was
    default, _ = state_dict_from_jax(_flat(layouts["v3"]), spec,
                                     schema_version=tckpt.SCHEMA_VERSION)
    assert all(torch.equal(default[k], want[k]) for k in want)
