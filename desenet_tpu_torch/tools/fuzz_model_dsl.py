"""Fuzz the port's model-DSL compiler (``models/build.py:parse_config``).

    python -m desenet_tpu_torch.tools.fuzz_model_dsl [N] [--seed S] [--verbose]

Counterpart of ``tools/fuzz_model_dsl.py``, with the same mutations. It
corrupts the bundled ``yolov5s_seg`` config (its structure, types and
values) and holds the compiler to its contract: ``parse_config`` returns
a ``ModelSpec`` or raises a clean ValueError, TypeError or KeyError, never
an internal error (IndexError, AttributeError, ZeroDivisionError,
RecursionError, ...) and never hangs (a 5 s alarm a config). Exits 1 when
it finds an unclean failure, each printed with the config that made it.
"""

from __future__ import annotations

import argparse
import copy
import json
import random
import signal
import sys

CLEAN = (ValueError, TypeError, KeyError)
ALARM_S = 5

JUNK = [None, True, -1, 0, 3.7, "x", "Conv", [], [[]], {}, {"a": 1},
        [1, 2, 3], "nan", float("nan"), -0.5, 10**9, [-1], ["Conv"], b"b"]


class ParseHang(Exception):
    """parse_config outlasted the alarm: a finding."""


def _alarm(signum, frame):
    raise ParseHang(f"parse_config exceeded {ALARM_S}s")


def _rand_row(rng):
    return [rng.choice([-1, 0, 1, [2, 3], "x"]),
            rng.choice([0, 1, 3, -2, "n"]),
            rng.choice(["Conv", "C3", "Focus", "Nope", 7, None, "Detect"]),
            rng.choice([[], [64], [64, 3], ["anchors"], [None], "args", 5])]


def mutate(cfg, rng):
    """1 to 3 random corruptions of a deep copy of ``cfg``."""
    c = copy.deepcopy(cfg)
    for _ in range(rng.randint(1, 3)):
        op = rng.randrange(9)
        if op == 0 and c:  # drop a top-level key
            c.pop(rng.choice(list(c)), None)
        elif op == 1 and c:  # junk a top-level value
            c[rng.choice(list(c))] = rng.choice(JUNK)
        elif op == 2:  # junk or new key
            c[rng.choice(["de_nc", "se_nc", "anchors", "zzz",
                          "depth_multiple", "width_multiple"])] = \
                rng.choice(JUNK)
        else:
            sect = rng.choice(["backbone", "head"])
            rows = c.get(sect)
            if not isinstance(rows, list) or not rows:
                c[sect] = rng.choice(JUNK)
                continue
            k = rng.randrange(len(rows))
            if op == 3:  # replace a row wholesale
                rows[k] = rng.choice(JUNK + [_rand_row(rng)])
            elif op == 4:  # corrupt one element of a row
                if isinstance(rows[k], list) and rows[k]:
                    rows[k] = list(rows[k])
                    rows[k][rng.randrange(len(rows[k]))] = rng.choice(
                        JUNK + [rng.randint(-30, 30)])
            elif op == 5:  # truncate the section
                del rows[k:]
            elif op == 6:  # duplicate a row
                rows.insert(k, copy.deepcopy(rows[k]))
            elif op == 7:  # random from-index
                if isinstance(rows[k], list) and rows[k]:
                    rows[k] = list(rows[k])
                    rows[k][0] = rng.choice(
                        [rng.randint(-30, 60),
                         [rng.randint(-30, 60), rng.randint(-30, 60)]])
            elif op == 8:  # corrupt the args list elementwise
                if (isinstance(rows[k], list) and len(rows[k]) == 4
                        and isinstance(rows[k][3], list) and rows[k][3]):
                    rows[k] = list(rows[k])
                    a = list(rows[k][3])
                    a[rng.randrange(len(a))] = rng.choice(JUNK)
                    rows[k][3] = a
    return c


def run(n: int, seed: int, verbose: bool = False) -> list:
    """Parse ``n`` corrupted configs drawn from ``seed``; returns the
    unclean failures as (exception name, message, config)."""
    from desenet_tpu_torch.models import config_path
    from desenet_tpu_torch.models.build import parse_config

    with open(config_path("yolov5s_seg"), encoding="utf-8") as f:
        base = json.load(f)
    rng = random.Random(seed)
    ok = raised = 0
    failures = []
    previous = signal.signal(signal.SIGALRM, _alarm)
    try:
        for i in range(n):
            cfg = mutate(base, rng)
            try:
                signal.alarm(ALARM_S)  # a parse is instant; a hang a finding
                parse_config(copy.deepcopy(cfg))
                ok += 1
            except CLEAN:
                raised += 1
            except Exception as e:  # noqa: BLE001 - the point of the fuzzer
                failures.append((type(e).__name__, str(e)[:200], cfg))
                if verbose:
                    import traceback

                    print(f"[{i}] UNCLEAN {type(e).__name__}: {e}")
                    traceback.print_exc()
            finally:
                signal.alarm(0)
    finally:
        signal.signal(signal.SIGALRM, previous)
    print(f"fuzz: {n} configs: {ok} parsed, {raised} clean-rejected, "
          f"{len(failures)} UNCLEAN")
    for name, msg, cfg in failures[:10]:
        print(f"\n== {name}: {msg}\n{json.dumps(cfg, default=repr)[:1500]}")
    return failures


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("n", nargs="?", type=int, default=2000)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--verbose", action="store_true")
    a = ap.parse_args(argv)
    return 1 if run(a.n, a.seed, a.verbose) else 0


if __name__ == "__main__":
    sys.exit(main())
