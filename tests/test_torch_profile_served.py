"""The served program's profiler (``desenet_tpu_torch/tools/profile_served``)
runs on the CPU at a tiny size: its two tables (the whole program, then the
Focus stem alone) come out with positive totals, the stem's below the
program's."""

import re

from desenet_tpu_torch.tools import profile_served


def test_profile_served_runs_on_the_cpu(capsys):
    assert profile_served.main(["--device", "cpu", "--batch", "1",
                                "--imgsz", "64"]) == 0
    out = capsys.readouterr().out
    totals = [float(t) for t in re.findall(r": ([0-9.]+) ms per run", out)]
    assert len(totals) == 2 and 0 < totals[1] < totals[0], out
    assert "served program b1/64" in out and "Focus stem alone" in out
    assert "aten::" in out
