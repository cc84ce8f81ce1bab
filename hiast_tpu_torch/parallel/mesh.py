"""The ``data`` and ``space`` axes of the JAX package's mesh as
``torch.distributed`` process groups.

The counterpart of ``hiast_tpu/parallel/mesh.py``.  There one program
shards each global batch over the ``data`` axis of a device mesh, and its
image rows over the ``space`` axis, and XLA emits the gradient all-reduce,
the synced BatchNorm moments, the global IAS histogram and IoU sums and the
convolutions' halo exchanges.  Here one process runs on each GPU, launched
by ``torchrun``, and the ranks form a ``data x space`` grid: rank
``d * space + s`` holds data index d and space index s, as JAX's
``devs.reshape(data, space, model)`` places its devices.  The ranks of one
data index load the same samples (``share``, ``local_share`` and
``stream_seed`` key on the data index) and each keeps its slab of their
rows (``local_rows``).  The port issues the collectives itself: over the
whole group the sums of a global batch (``models/norm.py``, the loss
denominators of ``ops/losses.py``, ``selftrain/steps.py``,
``pseudo/generator.py``, ``evaluation.py``), within ``space_group()`` the
halos, gathers and per-image sums of ``parallel/spatial.py``.  The ``model``
axis has no counterpart yet (ROADMAP A17); ``check_mesh`` refuses it, and
refuses ``space`` on the paths that run no slabs yet (ROADMAP A20).

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

_space = {"size": 1, "group": None}  # the space axis of this process's grid (set_space)


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
    _space.update(size=1, group=None)
    if initialized():
        dist.destroy_process_group()


def set_space(space: int) -> None:
    """Arrange the group as ``world / space`` data indices of ``space``
    ranks each and build each data index's space group, once (every rank
    builds every group, in one order).  ``check_mesh`` has held the sizes."""
    if space == _space["size"] or not initialized():
        return
    if space == 1:
        _space.update(size=1, group=None)
        return
    group = None
    for d in range(world_size() // space):
        g = dist.new_group(list(range(d * space, (d + 1) * space)))
        if rank() // space == d:
            group = g
    _space.update(size=space, group=group)


def space_size() -> int:
    return _space["size"]


def space_index() -> int:
    return rank() % space_size()


def space_group():
    """The process group of this rank's data index (None without a space axis)."""
    return _space["group"]


def data_size() -> int:
    return world_size() // space_size()


def data_index() -> int:
    return rank() // space_size()


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
    """(data index, data size) for ``BatchIterator``'s ``share``; None
    without a process group."""
    return (data_index(), data_size()) if initialized() else None


def local_share(global_n: int) -> slice:
    """This data index's contiguous share ``[d n / N, (d + 1) n / N)`` of
    ``global_n`` samples, the samples JAX's ``shard_batch`` puts on index d
    of the data axis."""
    n, d = data_size(), data_index()
    return slice(d * global_n // n, (d + 1) * global_n // n)


def local_rows(x, dim: int = 1):
    """This space index's contiguous slab of the ``dim`` axis of ``x`` (a
    numpy array or a tensor; image rows are axis 1 of NHWC and [B, H, W]),
    the rows JAX's ``shard_batch`` puts on index s of the space axis."""
    n = space_size()
    if n == 1:
        return x
    if x.shape[dim] % n:
        raise ValueError(f"{x.shape[dim]} image rows do not split over runtime.mesh.space={n}")
    h = x.shape[dim] // n
    index = [slice(None)] * x.ndim
    index[dim] = slice(space_index() * h, (space_index() + 1) * h)
    return x[tuple(index)]


def stream_seed(base: int, offset: int) -> int:
    """Each data index's own sample stream (JAX ``_stream_seed``,
    ``hiast_tpu/selftrain/trainers.py:197-199``): the ranks of one data
    index draw the same samples, crops and donors."""
    return base + offset + STREAM_SEED_STRIDE * data_index()


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


def check_mesh(cfg, batch: int | None = None, world: int | None = None, rows=None, stride: int = 1,
               path: str = "this path") -> None:
    """Refuse a ``runtime.mesh`` this process group cannot run.

    - ``model`` above 1 (ROADMAP A17);
    - ``space`` above 1 on a path that shards no rows (``rows`` None; ROADMAP
      A20, naming ``path``), or not dividing the world size;
    - a ``data`` axis other than -1 or ``world / space``;
    - a global ``batch`` (training) that the data axis does not divide: the
      JAX ``make_mesh`` caps its data axis to a divisor of the batch, but
      here the launcher fixed the world size, so this names the sizes that
      would fit;
    - each of ``rows`` (the image rows of every tensor the path shards) that
      does not split into ``space`` slabs of a multiple of ``stride`` rows,
      the model's row stride (its strided layers read whole windows of a
      slab, and the strong view's equalize grid starts each slab on a
      multiple of 4).

    ``world`` defaults to the group's size."""
    mesh, n = cfg.runtime.mesh, world or world_size()
    if mesh.model > 1:
        raise ValueError(f"runtime.mesh.model={mesh.model}: the port runs the data and space axes only; "
                         "the model axis is ROADMAP item A17")
    space = mesh.space
    if space > 1 and rows is None:
        raise ValueError(f"runtime.mesh.space={space}: {path} does not run with image rows sharded yet "
                         "(ROADMAP item A20)")
    if space < 1 or n % space:
        raise ValueError(f"runtime.mesh.space={space} does not divide the process group's {n} ranks")
    data = n // space
    if mesh.data not in (-1, data):
        raise ValueError(f"runtime.mesh.data={mesh.data} but the process group has {n} ranks at "
                         f"runtime.mesh.space={space}; set it to -1 or to {data}")
    if batch is not None and batch % data:
        fit = [k * space for k in range(1, batch + 1) if batch % k == 0]
        raise ValueError(f"the global batch of {batch} does not split over {data} data indices "
                         f"({n} ranks at runtime.mesh.space={space}); world sizes that fit it: {fit}")
    for r in rows or ():
        if space > 1 and r % (space * stride):
            raise ValueError(
                f"{r} image rows do not split over runtime.mesh.space={space} into slabs of a multiple of "
                f"{stride} rows (the model's row stride); rows that fit are multiples of {space * stride}, "
                f"e.g. {r // (space * stride) * space * stride or space * stride} or "
                f"{(r // (space * stride) + 1) * space * stride}")


def use_mesh(cfg, batch: int | None = None, rows=None, stride: int = 1, path: str = "this path") -> None:
    """``check_mesh``, then the grid of ``runtime.mesh.space`` (``set_space``)."""
    check_mesh(cfg, batch, rows=rows, stride=stride, path=path)
    set_space(cfg.runtime.mesh.space)
