"""Multi-process data-parallel glue over ``torch.distributed``.

The port's counterpart of ``desenet_tpu/parallel/multihost.py``, with its
names. There, every process runs one SPMD program over a global mesh and
XLA inserts the collectives; here every process drives one device (one
card, or the CPU), holds its rows of the global batch and takes the
collectives itself:

- ``init_multihost(coordinator, num_processes, process_id)`` joins the
  process group (NCCL for a card, gloo for the CPU, or the ``backend``
  given); with NCCL a gloo group beside it carries the host-side syncs;
- ``local_batch_slice`` is this process's rows of a global batch;
- ``sync_hosts(tag)`` is a barrier, ``broadcast_str`` and
  ``broadcast_float`` send process 0's value to all (the engine's run
  directory and fitness);
- ``global_sum`` adds a tensor over the processes without gradient (the
  losses' normalizers; under a spatial scope over the data axis only,
  since the ranks of a spatial group hold the same images),
  ``global_sum_grad`` with it (the BatchNorm statistics of the global
  batch: a spatial group's bands add up to its images), ``sum_gradients``
  adds the gradients in place (the gradient of the global batch's loss is
  their sum);
- ``host_count`` is the number of hosts the processes run on;
- ``spawn`` starts processes of one group on this host.

With tracing on (``utils/profiling``), each all-reduce that
``global_sum``, ``global_sum_grad`` and ``sum_gradients`` launch adds 1 to
the counter ``dist.allreduce.calls`` and its tensor's bytes to
``dist.allreduce.bytes`` (host ints), the backward's all-reduce of
``global_sum_grad`` too (a gradient hook, set only while tracing).

At one process (no group, or a group of one) each is the identity.
"""

from __future__ import annotations

import datetime
import logging
import pickle
import socket
from typing import Iterable, Optional

import torch
import torch.distributed as dist

from desenet_tpu_torch.parallel import mesh, spatial
from desenet_tpu_torch.utils.profiling import count, tracing

LOGGER = logging.getLogger("desenet_tpu_torch")

__all__ = [
    "init_multihost",
    "local_batch_slice",
    "sync_hosts",
    "broadcast_str",
    "broadcast_float",
    "global_sum",
    "host_count",
    "global_sum_grad",
    "sum_gradients",
    "spawn",
    "shutdown",
]

# the gloo group of the host-side syncs when the default group is NCCL
# (None: the default group is gloo and carries them)
_host_group = None


def init_multihost(coordinator_address: str, num_processes: int,
                   process_id: int, device=None,
                   backend: Optional[str] = None,
                   timeout_s: float = 1800.0) -> None:
    """Join the process group at ``coordinator_address`` ("host:port", the
    address of process 0). ``backend`` defaults to NCCL when ``device`` is
    a CUDA device, else gloo (gloo also takes CUDA tensors, and is the way
    to put two processes on one card, which NCCL refuses)."""
    global _host_group
    dev = torch.device(device) if device is not None else torch.device("cpu")
    if backend is None:
        backend = "nccl" if dev.type == "cuda" else "gloo"
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    timeout = datetime.timedelta(seconds=timeout_s)
    dist.init_process_group(backend, init_method=f"tcp://{coordinator_address}",
                            world_size=int(num_processes),
                            rank=int(process_id), timeout=timeout)
    _host_group = (dist.new_group(backend="gloo", timeout=timeout)
                   if backend != "gloo" else None)
    LOGGER.info("process %d of %d joined %s (%s) on %s", process_id,
                num_processes, coordinator_address, backend, dev)


def _counted(x: torch.Tensor) -> None:
    """One all-reduce of ``x`` in the counters (when tracing)."""
    count("dist.allreduce.calls", 1)
    count("dist.allreduce.bytes", x.numel() * x.element_size())


def shutdown() -> None:
    """Leave the process group (every process calls it)."""
    global _host_group
    if dist.is_available() and dist.is_initialized():
        dist.destroy_process_group()
    _host_group = None


def local_batch_slice(global_batch_size: int,
                      process_index: Optional[int] = None,
                      process_count: Optional[int] = None) -> slice:
    """This process's rows of a global batch: a contiguous, equal split of
    the leading axis (the global batch must divide evenly)."""
    pi = mesh.process_index() if process_index is None else process_index
    pc = mesh.process_count() if process_count is None else process_count
    if global_batch_size % pc:
        raise ValueError(f"global batch {global_batch_size} not divisible by "
                         f"{pc} processes")
    per = global_batch_size // pc
    return slice(pi * per, (pi + 1) * per)


def sync_hosts(tag: str = "sync") -> None:
    """Barrier across the processes, on the host (no device work waits on
    it). Every process must reach the same sequence of barriers; ``tag``
    names this one in the log."""
    if mesh.process_count() == 1:
        return
    LOGGER.debug("barrier %s", tag)
    dist.barrier(group=_host_group)


def broadcast_str(tag: str, value: Optional[str] = None) -> str:
    """Process 0's ``value`` on every process (the others pass None)."""
    if mesh.process_count() == 1:
        return value
    obj = [value if mesh.process_index() == 0 else None]
    dist.broadcast_object_list(obj, src=0, group=_host_group)
    LOGGER.debug("broadcast %s = %r", tag, obj[0])
    return obj[0]


def broadcast_float(value: float) -> float:
    """Process 0's ``value`` on every process."""
    if mesh.process_count() == 1:
        return float(value)
    t = torch.tensor([float(value)], dtype=torch.float64)
    dist.broadcast(t, src=0, group=_host_group)
    return float(t.item())


def global_sum(x: torch.Tensor) -> torch.Tensor:
    """``x`` summed over the processes (over the data axis under a spatial
    scope), with no gradient (a count or a normalizer); ``x`` itself at
    one process."""
    ctx = spatial.current()
    n = mesh.process_count() if ctx is None else ctx.mesh.n_data
    if n == 1:
        return x
    out = x.detach().clone()
    _counted(out)
    dist.all_reduce(out, group=None if ctx is None else ctx.mesh.data_group)
    return out


def host_count() -> int:
    """The number of distinct hosts of the processes (1 without a
    group)."""
    if mesh.process_count() == 1:
        return 1
    names = [None] * mesh.process_count()
    dist.all_gather_object(names, socket.gethostname(), group=_host_group)
    return len(set(names))


def global_sum_grad(x: torch.Tensor) -> torch.Tensor:
    """``x`` summed over the processes, with autograd through the sum: the
    gradient that reaches each process's ``x`` is the sum over the
    processes of the gradients at the result."""
    if mesh.process_count() == 1:
        return x
    from torch.distributed.nn.functional import all_reduce

    _counted(x)
    out = all_reduce(x)
    if tracing() and out.requires_grad:  # its backward's all-reduce
        out.register_hook(_counted)
    return out


def sum_gradients(grads: Iterable[torch.Tensor]) -> None:
    """Add each tensor of ``grads`` over the processes, in place, in one
    collective a dtype."""
    if mesh.process_count() == 1:
        return
    by_dtype = {}
    for g in grads:
        by_dtype.setdefault(g.dtype, []).append(g)
    for group in by_dtype.values():
        flat = torch.cat([g.reshape(-1) for g in group])
        _counted(flat)
        dist.all_reduce(flat)
        offset = 0
        for g in group:
            n = g.numel()
            g.copy_(flat[offset:offset + n].view_as(g))
            offset += n


def free_port() -> int:
    """A TCP port on localhost that is free now (for a coordinator)."""
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def _spawned(fn, rank: int, nproc: int, coordinator: str, args, conn):
    out = fn(rank, nproc, coordinator, *args)
    if rank == 0:  # by value: torch's pickler would share tensor storage
        conn.send_bytes(pickle.dumps(out))
    conn.close()


def spawn(fn, nproc: int, *args):
    """Run ``fn(rank, nproc, coordinator, *args)`` in ``nproc`` new
    processes (the "spawn" start method; ``fn`` and ``args`` must pickle),
    ``coordinator`` a free "localhost:port" for ``init_multihost``; returns
    process 0's return value. Raises if a process fails."""
    import multiprocessing as mp
    from multiprocessing.connection import wait

    ctx = mp.get_context("spawn")
    recv, send = ctx.Pipe(duplex=False)
    coordinator = f"localhost:{free_port()}"
    procs = [ctx.Process(target=_spawned,
                         args=(fn, r, nproc, coordinator, args, send))
             for r in range(nproc)]
    for p in procs:
        p.start()
    send.close()
    out, got = None, False
    # process 0's result, or its end without one
    if recv in wait([recv, procs[0].sentinel]) or recv.poll():
        try:
            out, got = pickle.loads(recv.recv_bytes()), True
        except EOFError:
            pass
    for p in procs:
        p.join()
    codes = [p.exitcode for p in procs]
    if any(codes) or not got:
        raise RuntimeError(f"{getattr(fn, '__name__', fn)} in {nproc} "
                           f"processes: exit codes {codes}")
    return out
