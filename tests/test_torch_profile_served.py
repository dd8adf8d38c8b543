"""The port's profilers run on the CPU at a tiny size. The served program's
(``desenet_tpu_torch/tools/profile_served``): its two tables (the whole
program, then the Focus stem alone) come out with positive totals, the
stem's below the program's. The seg head's (``profile_seg_head``): one table
for ``fused_psp2_eval`` and one for the module head. The validation step's
(``profile_val_step``): one table for either seg head. The training
step's (``profile_train_step``): one table for either seg loss. The three
that need a card (``profile_c3_phases``, ``profile_stem_phases``,
``mma_peak``) say so and exit."""

import re

import pytest
import torch

from desenet_tpu_torch.tools import (mma_peak, profile_c3_phases,
                                     profile_seg_head, profile_served,
                                     profile_stem_phases, profile_train_step,
                                     profile_val_step)


def test_profile_served_runs_on_the_cpu(capsys):
    assert profile_served.main(["--device", "cpu", "--batch", "1",
                                "--imgsz", "64"]) == 0
    out = capsys.readouterr().out
    totals = [float(t) for t in re.findall(r": ([0-9.]+) ms per run", out)]
    assert len(totals) == 2 and 0 < totals[1] < totals[0], out
    assert "served program b1/64" in out and "Focus stem alone" in out
    assert "aten::" in out


@pytest.mark.parametrize("tool", [profile_served, profile_val_step])
def test_profilers_take_a_config(capsys, tool):
    assert tool.main(["--device", "cpu", "--batch", "1", "--imgsz", "64",
                      "--cfg", "yolov5m_seg"]) == 0
    out = capsys.readouterr().out
    assert "yolov5m_seg served program b1/64" in out or \
        "yolov5m_seg val step b1/64" in out, out


def test_profile_seg_head_runs_on_the_cpu(capsys):
    assert profile_seg_head.main(["--device", "cpu", "--batch", "1",
                                  "--side", "16"]) == 0
    out = capsys.readouterr().out
    totals = [float(t) for t in re.findall(r": ([0-9.]+) ms per run", out)]
    assert len(totals) == 2 and min(totals) > 0, out
    assert "fused_psp2_eval (1, 16, 16) c_hid 128" in out
    assert "the module head (1, 16, 16)" in out and "aten::" in out


def test_profile_val_step_runs_on_the_cpu(capsys):
    assert profile_val_step.main(["--device", "cpu", "--batch", "1",
                                  "--imgsz", "64"]) == 0
    out = capsys.readouterr().out
    totals = [float(t) for t in re.findall(r": ([0-9.]+) ms per run", out)]
    assert len(totals) == 2 and min(totals) > 0, out
    assert "val step b1/64 with the module seg head" in out
    assert "val step b1/64 with the fused seg head (K4)" in out


def test_profile_train_step_runs_on_the_cpu(capsys):
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

