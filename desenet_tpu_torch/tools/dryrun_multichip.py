"""Data-parallel dry run: N processes take training steps of one global
batch, held against one process taking them on the whole batch.

    python -m desenet_tpu_torch.tools.dryrun_multichip [--nproc 2] \\
        [--device cuda|cuda:<i>|cpu]

The port's analog of ``__graft_entry__.dryrun_multichip`` (whose record is
``MULTICHIP_r05.json``): N gloo processes on the current card (``--device
cuda``, the default; without a card it raises and names ``--device cpu``)
or on the CPU (``--device cpu``), each
holding its rows of a global batch of 2N images (``testing.train_batch``),
take two full training steps of the tiny config (fused seg loss, SGD,
every step an optimizer step) in float64 from one seeded state; then one
process takes the same steps on the whole batch, and process 0's losses
and state are held to ``testing``'s float64 bars against it (in f32 the
tiny model's BN over a few values lets any two runs drift apart after the
first step, ``testing.TRAIN_PARITY_STEPS``). Prints one line::

    dryrun_multichip(2): ok - loss=... step2_loss=... dparams=... (one
    process on the global batch: loss rel err ..., params ...)

and exits non-zero on any failure. At ``--nproc`` 4 or more and even, as
``__graft_entry__.dryrun_multichip`` does, the same processes then take
one step as a ``dp(N/2) x sp2`` mesh (``--spatial 2``: each image's
height split over two processes, ``parallel/spatial.py``) at 128 px on a
global batch of N, against pure data parallelism over the N processes on
the same batch; the losses within the JAX dry run's 1e-3, and the whole
state within ``testing``'s float64 bars::

    dryrun_multichip(4): ok - dp2 x sp2 mesh loss=... (matches dp: loss
    rel err ..., params ...)

``run`` is the launcher that ``chip_smoke.py`` phases 11(b) and 14 also
take, with two processes on one card over gloo.
"""

from __future__ import annotations

import argparse
from typing import Optional

import torch


def _worker(rank: int, n: int, coordinator: str, device: str,
            backend: Optional[str], kw: dict):
    from desenet_tpu_torch.parallel import multihost
    from desenet_tpu_torch.testing import no_tf32, train_steps

    if torch.device(device).type == "cpu":
        torch.set_num_threads(1)
    multihost.init_multihost(coordinator, n, rank, device=device,
                             backend=backend)
    try:
        if kw.get("spatial", 1) == 1:
            kw = dict(kw, rows=multihost.local_batch_slice(kw["b"]))
        with no_tf32():
            return train_steps(device, **kw)
    finally:
        multihost.shutdown()


def run(nproc: int, device: str, backend: Optional[str] = None,
        **kw) -> list:
    """``testing.train_steps(device, rows=<this process's rows>, **kw)`` in
    ``nproc`` processes of one group (``backend`` as ``init_multihost``
    picks it); returns process 0's steps. ``kw`` needs ``b``, the global
    batch, and takes ``train_steps``' other keywords."""
    from desenet_tpu_torch.parallel.multihost import spawn

    return spawn(_worker, nproc, device, backend, kw)


def main(argv=None) -> None:
    from desenet_tpu_torch.models import build_model, init_weights
    from desenet_tpu_torch.testing import (check_train_parity, no_tf32,
                                           parity_errors, tiny_cfg,
                                           train_steps)
    from desenet_tpu_torch.train.engine import resolve_device

    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--nproc", type=int, default=2)
    p.add_argument("--device", default="cuda",
                   help="cuda (the current card), cuda:<i> (every process "
                        "on that card, gloo) or cpu")
    p.add_argument("--steps", type=int, default=2)
    args = p.parse_args(argv)
    args.device = str(resolve_device(args.device))

    kw = dict(fused=True, dtype=torch.float64, steps=args.steps, seed=0,
              b=2 * args.nproc)
    backend = "gloo" if args.device.startswith("cuda") else None
    got = run(args.nproc, args.device, backend, **kw)
    torch.set_num_threads(1)
    with no_tf32():
        want = train_steps(args.device, **kw)
    errs = parity_errors(got, want)
    check_train_parity(errs, kw["dtype"], f"dryrun_multichip({args.nproc})")
    model, _ = build_model(tiny_cfg(), seg_upsample=False, train=True)
    init_weights(model, torch.Generator().manual_seed(kw["seed"]))
    init = {k: v.double() for k, v in model.state_dict().items()}
    last = got[-1][1]["params"]
    dparams = sum(float((v - init[k]).abs().sum()) for k, v in last.items())
    print(f"dryrun_multichip({args.nproc}): ok - loss={got[0][0]:.4f} "
          f"step{len(got)}_loss={got[-1][0]:.4f} dparams={dparams:.3e} (one "
          f"process on the global batch: loss rel err "
          f"{max(e['loss'] for e in errs):.2e}, params "
          f"{max(e['params'][0] for e in errs):.2e})", flush=True)
    if args.nproc >= 4 and args.nproc % 2 == 0:
        spatial_phase(args.nproc, args.device, backend)


def spatial_phase(nproc: int, device: str, backend: Optional[str]) -> None:
    """One float64 step of a ``dp(nproc/2) x sp2`` mesh at 128 px (the
    deepest map keeps 2 rows a band, ``check_spatial``) against pure data
    parallelism on the same global batch of ``nproc``."""
    from desenet_tpu_torch.testing import check_train_parity, parity_errors

    kw = dict(fused=True, dtype=torch.float64, steps=1, seed=0, b=nproc,
              imgsz=128)
    got = run(nproc, device, backend, spatial=2, **kw)
    want = run(nproc, device, backend, **kw)
    errs = parity_errors(got, want)
    if abs(got[0][0] - want[0][0]) >= 1e-3:
        raise AssertionError(f"dp x sp loss {got[0][0]} against dp "
                             f"{want[0][0]}")
    check_train_parity(errs, kw["dtype"],
                       f"dryrun_multichip({nproc}) dp x sp")
    print(f"dryrun_multichip({nproc}): ok - dp{nproc // 2} x sp2 mesh "
          f"loss={got[0][0]:.4f} (matches dp: loss rel err "
          f"{errs[0]['loss']:.2e}, params {errs[0]['params'][0]:.2e})",
          flush=True)


if __name__ == "__main__":
    main()
