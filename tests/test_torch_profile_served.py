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


def test_ab_served_inputs_summary_and_refusals(tmp_path, monkeypatch):
    """The side-by-side timing tool: its inputs are seeded and of the served
    shapes, its summary is the mean per tree, and without another checkout
    or without a card it refuses."""
    import numpy as np

    from desenet_tpu_torch.tools import ab_served

    assert (ab_served.BATCH, ab_served.IMGSZ) == (128, 640)
    monkeypatch.setattr(ab_served, "BATCH", 2)  # small for the CPU
    ab_served.make_inputs(str(tmp_path / "in.npz"))
    data = np.load(tmp_path / "in.npz")
    assert data["sparse"].shape == data["dense"].shape == (2, 25200, 11)
    assert data["logits"].shape == (2, 80, 80, 3)
    # the dense decode: 3000 anchors pass conf 0.25
    conf = data["dense"][..., 4:5] * data["dense"][..., 5:]
    assert ((data["dense"][..., 4] > 0.25)
            & (conf.max(-1) > 0.25)).sum(1).tolist() == [3000, 3000]
    runs = [dict(tree=t, **{m: v for m in ab_served.METRICS})
            for t, v in (("a", 1.0), ("b", 5.0), ("b", 7.0), ("a", 2.0))]
    means = ab_served.summarise(runs)
    assert means["a"]["k2_ms"] == 1.5 and means["b"]["program_ms"] == 6.0
    qruns = [dict(tree=t, **{m: v for m in ab_served.QUANT_METRICS})
             for t, v in (("a", 1.0), ("b", 5.0), ("b", 7.0), ("a", 2.0))]
    qmeans = ab_served.summarise(qruns, ab_served.QUANT_METRICS)
    assert qmeans["a"]["val_fp8_ms"] == 1.5
    assert qmeans["b"]["int8_program_ms"] == 6.0
    with pytest.raises(SystemExit, match="--against"):
        ab_served.main(["--against", str(tmp_path)])
    if not torch.cuda.is_available():
        with pytest.raises(SystemExit, match="no CUDA device"):
            ab_served.main(["--worker", str(tmp_path / "in.npz")])
        with pytest.raises(SystemExit, match="no CUDA device"):
            ab_served.main(["--worker", str(tmp_path / "in.npz"), "--quant"])
