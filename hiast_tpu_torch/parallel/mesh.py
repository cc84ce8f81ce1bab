"""The ``data`` axis of the JAX package's mesh as a ``torch.distributed``
process group.

The counterpart of ``hiast_tpu/parallel/mesh.py``.  There one program
shards each global batch over the ``data`` axis of a device mesh, and XLA
emits the gradient all-reduce, the synced BatchNorm moments and the global
IAS histogram and IoU sums.  Here one process runs on each GPU, launched by
``torchrun``, and the ``data`` axis is the default process group: each rank
takes its contiguous share of every global batch (``local_share``), and the
port issues those collectives itself (``models/norm.py``, the loss
denominators of ``ops/losses.py``, ``selftrain/steps.py``,
``pseudo/generator.py``, ``evaluation.py``).  The ``space`` and ``model``
axes have no counterpart yet (ROADMAP A17); ``check_mesh`` refuses them.

Without ``WORLD_SIZE`` in the environment nothing is initialised, every
helper answers for one process and every collective is skipped: the path
of a run without ``torchrun``.
"""
from __future__ import annotations

import contextlib
import os

import torch
import torch.distributed as dist

STREAM_SEED_STRIDE = 7919  # the JAX trainer's per-process stream offset


def launched() -> bool:
    """Whether the environment describes a process group (``torchrun``)."""
    return "WORLD_SIZE" in os.environ


def initialized() -> bool:
    return dist.is_available() and dist.is_initialized()


def init(device: str = "cuda", backend: str | None = None, init_method: str | None = None) -> torch.device:
    """Join the process group that torchrun's environment describes
    (``WORLD_SIZE``, ``RANK``, ``LOCAL_RANK``) and return this process's
    device: ``cuda:{LOCAL_RANK}`` for ``device`` 'cuda', the CPU for 'cpu'.
    The backend is ``nccl`` on the card and ``gloo`` on the CPU unless
    ``backend`` says otherwise; ``init_method`` defaults to ``env://``
    (``MASTER_ADDR``, ``MASTER_PORT``).  A group a caller joined already is
    kept.  Without either, nothing is initialised and ``device`` is
    returned.  A request for the card without one, and a failed
    initialisation, raise."""
    kind = torch.device(device).type
    if kind == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "--device cuda was requested but torch sees no CUDA device; "
            "pass --device cpu to run the plain PyTorch path"
        )
    if not (initialized() or launched()):
        return torch.device(device)
    out = torch.device("cuda", int(os.environ.get("LOCAL_RANK", 0))) if kind == "cuda" else torch.device("cpu")
    if out.type == "cuda":
        torch.cuda.set_device(out)
    if not initialized():
        backend = backend or ("nccl" if kind == "cuda" else "gloo")
        dist.init_process_group(
            backend, init_method=init_method or "env://", world_size=int(os.environ["WORLD_SIZE"]),
            rank=int(os.environ["RANK"]), **({"device_id": out} if backend == "nccl" else {}),
        )
    return out


@contextlib.contextmanager
def session(device: str = "cuda"):
    """``init(device)`` for the body of an entry point; a group joined here
    is left at its end (a caller's group stays)."""
    owned = not initialized()
    try:
        yield init(device)
    finally:
        if owned:
            destroy()


def destroy() -> None:
    if initialized():
        dist.destroy_process_group()


def world_size() -> int:
    return dist.get_world_size() if initialized() else 1


def rank() -> int:
    return dist.get_rank() if initialized() else 0


def is_main() -> bool:
    return rank() == 0


def barrier() -> None:
    if initialized():
        dist.barrier()


def all_reduce_sum(tensors: list[torch.Tensor]) -> list[torch.Tensor]:
    """Sum each tensor over the ranks, in place, through one flat buffer
    per dtype (one collective a dtype).  Returns ``tensors``."""
    if not initialized() or not tensors:
        return tensors
    by_dtype: dict = {}
    for t in tensors:
        by_dtype.setdefault(t.dtype, []).append(t)
    for group in by_dtype.values():
        flat = torch.cat([t.reshape(-1) for t in group])
        dist.all_reduce(flat)
        for t, part in zip(group, torch.split(flat, [t.numel() for t in group])):
            t.copy_(part.view_as(t))
    return tensors


def summed(t: torch.Tensor) -> torch.Tensor:
    """A detached copy of ``t`` summed over the ranks (``t`` itself without
    a group)."""
    if not initialized():
        return t
    out = t.detach().clone()
    dist.all_reduce(out)
    return out


def any_rank(flag: bool, device: torch.device) -> bool:
    """Whether ``flag`` is set on any rank (a read from ``device``)."""
    if not initialized():
        return flag
    t = torch.tensor([int(flag)], device=device)
    dist.all_reduce(t)
    return bool(t.item())


def share() -> tuple[int, int] | None:
    """(rank, world size) for ``BatchIterator``'s ``share``; None without a
    process group."""
    return (rank(), world_size()) if initialized() else None


def local_share(global_n: int) -> slice:
    """This rank's contiguous share ``[r n / N, (r + 1) n / N)`` of ``global_n``
    rows, the rows JAX's ``shard_batch`` puts on device r of the data axis."""
    n, r = world_size(), rank()
    return slice(r * global_n // n, (r + 1) * global_n // n)


def stream_seed(base: int, offset: int) -> int:
    """Each rank's own sample stream (JAX ``_stream_seed``,
    ``hiast_tpu/selftrain/trainers.py:197-199``)."""
    return base + offset + STREAM_SEED_STRIDE * rank()


def broadcast_object(obj):
    """Rank 0's ``obj`` on every rank."""
    if not initialized():
        return obj
    box = [obj]
    dist.broadcast_object_list(box, src=0)
    return box[0]


def gather_objects(obj) -> list:
    """Every rank's ``obj``, in rank order, on every rank."""
    if not initialized():
        return [obj]
    out = [None] * world_size()
    dist.all_gather_object(out, obj)
    return out


def broadcast_module(module: torch.nn.Module) -> None:
    """Rank 0's parameters and buffers into every rank's ``module``."""
    if not initialized():
        return
    with torch.no_grad():
        for t in list(module.parameters()) + list(module.buffers()):
            dist.broadcast(t.data, src=0)


def check_mesh(cfg, batch: int | None = None, world: int | None = None) -> None:
    """Refuse a ``runtime.mesh`` this process group cannot run: a ``space``
    or ``model`` axis above 1 (ROADMAP A17), a ``data`` axis other than -1
    or the world size, and a global ``batch`` (training) that the world size
    does not divide.  The JAX ``make_mesh`` caps the data axis to a divisor
    of the batch; here the launcher fixed the world size, so this names the
    world sizes that would fit.  ``world`` defaults to the group's size."""
    mesh, n = cfg.runtime.mesh, world or world_size()
    for axis in ("space", "model"):
        if getattr(mesh, axis) > 1:
            raise ValueError(
                f"runtime.mesh.{axis}={getattr(mesh, axis)}: the port runs the data axis only; "
                "the space and model axes are ROADMAP item A17"
            )
    if mesh.data not in (-1, n):
        raise ValueError(f"runtime.mesh.data={mesh.data} but the process group has {n} ranks; "
                         "set it to -1 or to the world size")
    if batch is not None and batch % n:
        raise ValueError(f"the global batch of {batch} does not split over {n} ranks; "
                         f"world sizes that fit it: {[k for k in range(1, batch + 1) if batch % k == 0]}")
