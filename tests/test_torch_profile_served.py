"""The port's profilers run on the CPU at a tiny size: the tests' tiny_psp2
graph (``testing.tiny_cfg``, written to a JSON file) where a tool builds a
model, given by ``--cfg`` or, for the training step, by its ``CFG``.

The served program's (``desenet_tpu_torch/tools/profile_served``): its
two tables (the whole program, then the Focus stem alone) come out with
positive totals, the stem's below the program's. The seg head's
(``profile_seg_head``): one table for ``fused_psp2_eval`` and one for the
module head. The validation step's (``profile_val_step``): one table for
either seg head. The training step's (``profile_train_step``): one table
for either seg loss. The three that need a card (``profile_c3_phases``,
``profile_stem_phases``, ``mma_peak``) say so and exit."""

import json
import re

import pytest
import torch

from desenet_tpu_torch.testing import tiny_cfg
from desenet_tpu_torch.tools import (mma_peak, profile_c3_phases,
                                     profile_seg_head, profile_served,
                                     profile_stem_phases, profile_train_step,
                                     profile_val_step)


@pytest.fixture(autouse=True)
def one_thread():
    """The tiny graph's ops are too small to share out over threads; on
    cores shared with other test processes, threads that wait for each
    other at every op cost far more than they save."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture
def tiny_json(tmp_path) -> str:
    path = tmp_path / "tiny_psp2.json"
    path.write_text(json.dumps(tiny_cfg()))
    return str(path)


def test_profile_served_runs_on_the_cpu(capsys, tiny_json):
    assert profile_served.main(["--device", "cpu", "--batch", "1",
                                "--imgsz", "64", "--cfg", tiny_json]) == 0
    out = capsys.readouterr().out
    totals = [float(t) for t in re.findall(r": ([0-9.]+) ms per run", out)]
    assert len(totals) == 2 and 0 < totals[1] < totals[0], out
    assert "served program b1/64" in out and "Focus stem alone" in out
    assert "aten::" in out


@pytest.mark.parametrize("tool", [profile_served, profile_val_step])
def test_profilers_take_a_config(capsys, tool, tiny_json):
    assert tool.main(["--device", "cpu", "--batch", "1", "--imgsz", "64",
                      "--cfg", tiny_json]) == 0
    out = capsys.readouterr().out
    assert f"{tiny_json} served program b1/64" in out or \
        f"{tiny_json} val step b1/64" in out, out


def test_profile_seg_head_runs_on_the_cpu(capsys):
    assert profile_seg_head.main(["--device", "cpu", "--batch", "1",
                                  "--side", "16"]) == 0
    out = capsys.readouterr().out
    totals = [float(t) for t in re.findall(r": ([0-9.]+) ms per run", out)]
    assert len(totals) == 2 and min(totals) > 0, out
    assert "fused_psp2_eval (1, 16, 16) c_hid 128" in out
    assert "the module head (1, 16, 16)" in out and "aten::" in out


def test_profile_val_step_runs_on_the_cpu(capsys, tiny_json):
    assert profile_val_step.main(["--device", "cpu", "--batch", "1",
                                  "--imgsz", "64", "--cfg", tiny_json]) == 0
    out = capsys.readouterr().out
    totals = [float(t) for t in re.findall(r": ([0-9.]+) ms per run", out)]
    assert len(totals) == 2 and min(totals) > 0, out
    assert "val step b1/64 with the module seg head" in out
    assert "val step b1/64 with the fused seg head (K4)" in out


def test_profile_train_step_runs_on_the_cpu(capsys, tiny_json, monkeypatch):
    monkeypatch.setattr(profile_train_step, "CFG", tiny_json)
    assert profile_train_step.main(["--device", "cpu", "--batch", "1",
                                    "--imgsz", "64"]) == 0
    out = capsys.readouterr().out
    totals = [float(t) for t in re.findall(r": ([0-9.]+) ms per run", out)]
    assert len(totals) == 2 and min(totals) > 0, out
    assert "train step b1/64, fused seg loss" in out
    assert "train step b1/64, materialized seg loss" in out
    assert "convolution_backward" in out


@pytest.mark.parametrize("tool", [profile_c3_phases, profile_stem_phases,
                                  mma_peak])
def test_card_only_tools_refuse_without_a_card(tool):
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    with pytest.raises(SystemExit, match="no CUDA device"):
        tool.main([])

