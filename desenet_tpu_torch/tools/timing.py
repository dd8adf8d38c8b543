"""Timing on the card, shared by the probes and ``chip_smoke.py``."""

from __future__ import annotations

import subprocess

import torch


def card_line() -> str:
    """The card's name and power limit as nvidia-smi prints them."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def cuda_ms(fn, reps: int) -> float:
    """Mean milliseconds of ``fn()`` over ``reps`` back-to-back runs, timed
    with CUDA events after one untimed run."""
    fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def in_turns(*runs) -> list:
    """Time ``(fn, reps)`` runs in order and then in reverse order (A B C C
    B A); return each one's mean of its two means, in ms."""
    first = [cuda_ms(fn, reps) for fn, reps in runs]
    second = [cuda_ms(fn, reps) for fn, reps in reversed(runs)][::-1]
    return [(a + b) / 2 for a, b in zip(first, second)]
