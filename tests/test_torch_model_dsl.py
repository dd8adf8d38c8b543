"""The port's model-DSL compiler (``desenet_tpu_torch/models/build.py:
parse_config``) under the JAX package's robustness cases: every fixed case
of ``tests/test_model_dsl_errors.py`` (the JAX compiler's clean
ValueErrors for malformed configs, and the fuzz-found crashers) run as it
stands with the port's ``parse_config`` in place of the JAX one, and the
port's fuzzer (``desenet_tpu_torch/tools/fuzz_model_dsl.py``) over 2000
corrupted configs with no unclean failure."""

import pytest
import test_model_dsl_errors as jax_cases

from desenet_tpu_torch.models.build import parse_config
from desenet_tpu_torch.tools import fuzz_model_dsl


def _fixed_cases():
    """(test name, keyword arguments) of every fixed case there, its
    parametrized ones one by one."""
    for name, fn in sorted(vars(jax_cases).items()):
        if not name.startswith("test_") or name == "test_fuzz_compiler_contract":
            continue
        marks = [m for m in getattr(fn, "pytestmark", [])
                 if m.name == "parametrize"]
        if not marks:
            yield pytest.param(name, {}, id=name)
            continue
        argname, values = marks[0].args
        for j, v in enumerate(values):
            yield pytest.param(name, {argname: v}, id=f"{name}[{j}]")


FIXED = list(_fixed_cases())


def test_fixed_cases_are_all_taken():
    assert len(FIXED) == 22


@pytest.mark.parametrize("name,kw", FIXED)
def test_fixed_case_on_the_port(monkeypatch, name, kw):
    monkeypatch.setattr(jax_cases, "parse_config", parse_config)
    getattr(jax_cases, name)(**kw)


@pytest.mark.parametrize("mode", [10**9, 0, "nan", None, ["nearest"]])
def test_upsample_mode_junk_is_a_value_error(mode):
    """Found by the port's fuzzer: a mode that names no upsampling raised
    NotImplementedError (an unclean error); it is a ValueError now, and a
    real mode other than nearest stays NotImplementedError
    (test_torch_convert.py::test_unported_rows_raise)."""
    cfg = jax_cases.base_cfg()
    cfg["backbone"].insert(1, [-1, 1, "nn.Upsample", [None, 2, mode]])
    with pytest.raises(ValueError, match="mode must be one of"):
        parse_config(cfg)


def test_fuzz_compiler_contract():
    """2000 corrupted configs: a spec or a ValueError/TypeError/KeyError,
    never an internal error and never a hang (5 s alarm a config)."""
    assert fuzz_model_dsl.run(2000, seed=0) == []
