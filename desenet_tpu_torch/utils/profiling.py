"""Profiling and model-info utilities.

Counterpart of ``desenet_tpu/utils/profiling.py``: ``Profile`` (wall clock
with a device sync), ``time_fn`` (steady-state seconds a call,
``torch.cuda.synchronize`` where the result lies on a card), ``profile_fn``
(forward and, with ``with_grad``, forward plus backward ms of an op, and
its FLOPs), ``flops_estimate`` (``torch.utils.flop_counter.FlopCounterMode``),
``model_info`` (parameters and GFLOPs at ``img_size``), ``trace``
(``torch.profiler`` into a Chrome trace), ``fold_conv_bn`` (from
``utils/fold.py``), ``sparsity`` and ``prune`` over the conv weights of a
state dict.

FLOPs differ from the JAX package's by design: XLA's cost analysis counts
every elementwise operation of the compiled program, the torch counter
counts the products (convolutions and matmuls, 2 a multiply-add) and
nothing else. The parameter count is the JAX package's: the BNs that never
run and the training-only aux heads, which the JAX variables lack
(``DeSeNet.quirk_bn_keys``, ``train_only_keys``), are not counted.
"""

from __future__ import annotations

import contextlib
import os
import time
from typing import Callable, Dict, Mapping

import numpy as np
import torch

from desenet_tpu_torch.utils.fold import fold_conv_bn  # noqa: F401


def _cuda_devices(out) -> set:
    """The CUDA devices of the tensors in ``out`` (nested lists, tuples and
    dicts)."""
    if isinstance(out, torch.Tensor):
        return {out.device} if out.is_cuda else set()
    if isinstance(out, (list, tuple)):
        return set().union(*(_cuda_devices(v) for v in out)) if out else set()
    if isinstance(out, dict):
        return _cuda_devices(list(out.values()))
    return set()


def _sync(out) -> None:
    for dev in _cuda_devices(out):
        torch.cuda.synchronize(dev)


class Profile(contextlib.ContextDecorator):
    """``with Profile():`` or ``@Profile()``: wall-clock seconds in ``.t``,
    printed; the current card (where CUDA is initialized) is synchronized
    at both ends."""

    def __init__(self, name: str = ""):
        self.name = name
        self.t = 0.0

    @staticmethod
    def _sync_current():
        if torch.cuda.is_available() and torch.cuda.is_initialized():
            torch.cuda.synchronize()

    def __enter__(self):
        self._sync_current()
        self.start = time.perf_counter()
        return self

    def __exit__(self, *exc):
        self._sync_current()
        self.t = time.perf_counter() - self.start
        print(f"{self.name or 'profile'}: {self.t:.4f}s")
        return False


def time_fn(fn: Callable, *args, iters: int = 10, warmup: int = 2) -> float:
    """Steady-state seconds a call of ``fn(*args)``, the result's cards
    synchronized after the warm-up and after the timed calls."""
    for _ in range(warmup):
        _sync(fn(*args))
    t0 = time.perf_counter()
    for _ in range(iters):
        out = fn(*args)
    _sync(out)
    return (time.perf_counter() - t0) / iters


def profile_fn(fn: Callable, *args, iters: int = 10,
               with_grad: bool = False) -> Dict[str, float]:
    """``{"forward_ms", "gflops"}`` of ``fn(*args)`` (forward without
    autograd), and with ``with_grad`` ``"backward_ms"``: the forward and
    the backward of the sum of the output in f32, as ``jax.grad`` times
    them, into every tensor that requires a gradient (a module's
    parameters; floating-point tensor arguments are made to)."""
    with torch.no_grad():
        fwd = time_fn(fn, *args, iters=iters)
    out = {"forward_ms": fwd * 1e3, "gflops": flops_estimate(fn, *args) / 1e9}
    if with_grad:
        gargs = [a.detach().requires_grad_(True)
                 if isinstance(a, torch.Tensor) and a.is_floating_point()
                 else a for a in args]

        def fwd_bwd(*a):
            y = fn(*a)
            y = y if isinstance(y, torch.Tensor) else torch.cat(
                [v.flatten() for v in y])
            y.float().sum().backward()
            return y

        out["backward_ms"] = time_fn(fwd_bwd, *gargs, iters=iters) * 1e3
    return out


def flops_estimate(fn: Callable, *args) -> float:
    """FLOPs of one ``fn(*args)`` by ``FlopCounterMode``: convolutions and
    matmuls at 2 a multiply-add."""
    from torch.utils.flop_counter import FlopCounterMode

    counter = FlopCounterMode(display=False)
    with torch.no_grad(), counter:
        fn(*args)
    return float(counter.get_total_flops())


def count_params(model) -> int:
    """The parameters of ``model`` that the JAX package's variables hold:
    all, less the never-run BNs and the training-only modules."""
    skip = set(model.quirk_bn_keys()) | set(model.train_only_keys())
    return sum(p.numel() for k, p in model.named_parameters() if k not in skip)


def model_info(model, img_size: int = 640) -> Dict[str, float]:
    """Parameters and eval-forward GFLOPs of a ``DeSeNet`` at one image of
    ``img_size``, on the model's device and in its dtype; printed as a
    banner."""
    p = next(model.parameters())
    x = torch.zeros((1, model.spec.ch_in, img_size, img_size),
                    dtype=p.dtype, device=p.device)
    was = model.training
    model.eval()
    try:
        gflops = flops_estimate(model, x) / 1e9
    finally:
        model.train(was)
    n_params = count_params(model)
    print(f"model: {n_params / 1e6:.2f}M params, {gflops:.1f} GFLOPs "
          f"@ {img_size}px")
    return {"params": n_params, "gflops": gflops}


@contextlib.contextmanager
def trace(log_dir: str = "runs/trace"):
    """``torch.profiler`` over the block (the CPU, and the cards where CUDA
    is available), written to ``log_dir/trace.json`` as a Chrome trace
    (chrome://tracing, Perfetto); yields the profiler."""
    from torch.profiler import ProfilerActivity, profile

    acts = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with profile(activities=acts) as prof:
        yield prof
    prof.export_chrome_trace(os.path.join(log_dir, "trace.json"))


def _conv_weights(sd: Mapping[str, torch.Tensor]):
    return [k for k, v in sd.items() if k.endswith("weight") and v.dim() == 4]


def sparsity(sd: Mapping[str, torch.Tensor]) -> float:
    """Global fraction of zero entries over the tensors of ``sd`` (a state
    dict or ``dict(model.named_parameters())``)."""
    total = zeros = 0
    for v in sd.values():
        total += v.numel()
        zeros += int((v == 0).sum())
    return zeros / max(total, 1)


def prune(sd: Mapping[str, torch.Tensor], amount: float = 0.3
          ) -> Dict[str, torch.Tensor]:
    """L1 unstructured pruning of each conv weight of ``sd``: the entries
    below the magnitude of the ``int(numel * amount)``-th smallest (0-based)
    become zero. Returns a new dict; other entries pass through."""
    out = dict(sd)
    for k in _conv_weights(sd):
        w = sd[k]
        n = int(w.numel() * amount)
        if n == 0:
            continue
        a = w.detach().abs()
        thresh = np.partition(a.flatten().cpu().numpy(), n)[n]
        out[k] = torch.where(a < torch.as_tensor(thresh, dtype=w.dtype,
                                                 device=w.device),
                             torch.zeros_like(w), w)
    return out
