"""Process meshes and the collectives over them (port of the JAX package's
``parallel/mesh.py``).

JAX runs one process over a mesh of devices; PyTorch runs one process a
device over a ``torch.distributed`` process group. So a ``Mesh`` here is a
process group with one 'data' axis: its ranks in order, this process's
place among them and the device it computes on (the card under NCCL, the
CPU under gloo; a mesh never switches between them). Every mesh-taking
function of the port keeps the JAX function's signature and output: each
rank calls it with the same arguments and gets the same global result
back; only rank 0 writes files.

- ``make_mesh`` / ``make_mesh_for_batch`` / ``fit_mesh``: JAX's shrink rule
  (the largest rank count that divides the batch; ``fit_mesh`` returns
  None at one). A shrunk mesh is a subgroup of the first n ranks, made
  once by its members (``dist.new_group`` with local synchronization)
  and cached; ranks outside it skip the computation and receive the
  result (``share``).
- ``shard_batch``: this rank's rows of a global host batch.
- ``fsdp_param_spec``: JAX's FSDP rule (the largest dimension that the
  axis divides, else replicate), as the dimension index or None.
- The collectives: every collective the port issues goes through the
  helpers below, which count themselves in ``COUNTS`` (reset with
  ``reset_collective_counts``), so that tests can audit a path's
  traffic. ``gather_with_grad`` is the all-gather that autograd can
  differentiate: its backward sums the incoming gradients over the ranks
  and keeps this rank's slice.
"""
from __future__ import annotations

import datetime
import os
import pickle
from dataclasses import dataclass

import numpy as np
import torch
import torch.distributed as dist

COUNTS = {"all_gather": 0, "all_reduce": 0, "reduce_scatter": 0,
          "broadcast": 0, "barrier": 0}


def reset_collective_counts() -> None:
    for key in COUNTS:
        COUNTS[key] = 0


@dataclass(frozen=True, eq=False)
class Mesh:
    """A 1-D mesh over the process-group ranks ``ranks`` (global ranks, in
    mesh order). ``group`` None is the default group. ``parent`` is the
    mesh this one was fitted from (None for a full mesh)."""

    group: object
    ranks: tuple[int, ...]
    device: torch.device
    axis_name: str = "data"
    parent: "Mesh | None" = None

    @property
    def size(self) -> int:
        return len(self.ranks)

    @property
    def rank(self) -> int:
        """This process's place on the axis, or -1 outside the mesh."""
        me = dist.get_rank()
        return self.ranks.index(me) if me in self.ranks else -1

    @property
    def member(self) -> bool:
        return self.rank >= 0


def _check_device(backend: str, device) -> torch.device:
    if backend == "nccl":
        want = torch.device("cuda", torch.cuda.current_device())
    elif backend == "gloo":
        want = torch.device("cpu")
    else:
        raise ValueError(f"unsupported backend {backend!r}")
    if device is not None and torch.device(device).type != want.type:
        raise ValueError(
            f"a {backend} process group computes on {want.type}, not on "
            f"{torch.device(device)}: NCCL meshes run on the card and gloo "
            "meshes on the CPU")
    return want


def make_mesh(group=None, device=None, data_axis: str = "data") -> Mesh:
    """A mesh over every rank of ``group`` (default: the world). The
    device follows the backend: the rank's current card under NCCL, the
    CPU under gloo; ``device``, where given, must agree."""
    if not dist.is_initialized():
        raise RuntimeError("make_mesh needs an initialized process group "
                           "(torchrun, --mesh auto or parallel/launch.py)")
    dev = _check_device(dist.get_backend(group), device)
    ranks = tuple(range(dist.get_world_size())) if group is None \
        else tuple(dist.get_process_group_ranks(group))
    return Mesh(group, ranks, dev, data_axis)


_SUBGROUPS: dict = {}


def _submesh(mesh: Mesh, n: int) -> Mesh:
    """The mesh over ``mesh``'s first n ranks. Every rank of ``mesh``
    calls this with the same n, in the same order (the subgroup is made
    once, by its members alone, and cached)."""
    if n == mesh.size:
        return mesh
    ranks = mesh.ranks[:n]
    # keyed by the world too: a process may join another group later
    key = (ranks, mesh.device.type, id(dist.group.WORLD))
    group = _SUBGROUPS.get(key)
    if group is None:
        group = _SUBGROUPS[key] = dist.new_group(
            list(ranks), use_local_synchronization=True)
    return Mesh(group, ranks, mesh.device, mesh.axis_name,
                mesh.parent or mesh)


def fit_mesh(mesh: Mesh | None, batch_size: int,
             data_axis: str = "data") -> Mesh | None:
    """Shrink a mesh so its axis divides ``batch_size``. None when only one
    rank fits: callers then skip sharding entirely."""
    if mesh is None:
        return None
    n = mesh.size
    while n > 1 and batch_size % n != 0:
        n -= 1
    if n <= 1:
        return None
    return mesh if n == mesh.size else _submesh(mesh, n)


def make_mesh_for_batch(batch_size: int, group=None, device=None,
                        data_axis: str = "data") -> Mesh:
    """A mesh over the largest rank count that divides ``batch_size`` (a
    mesh of the first rank alone when none does)."""
    mesh = make_mesh(group, device, data_axis)
    fitted = fit_mesh(mesh, batch_size, data_axis)
    return fitted if fitted is not None else _submesh(mesh, 1)


def fsdp_param_spec(shape, axis_size: int) -> int | None:
    """The dimension FSDP shards a parameter of ``shape`` on: the largest
    one that ``axis_size`` divides (the first of equal ones), else None
    (replicated). JAX's ``fsdp_param_spec`` as an index."""
    shape = tuple(shape)
    for i in sorted(range(len(shape)), key=lambda i: -shape[i]):
        if shape[i] >= axis_size and shape[i] % axis_size == 0:
            return i
    return None


def shard_rows(mesh: Mesh, n: int) -> slice:
    """This rank's contiguous block of ``n`` rows (``n`` divisible by the
    mesh size)."""
    if n % mesh.size:
        raise ValueError(f"{n} rows do not split over {mesh.size} ranks")
    b = n // mesh.size
    return slice(mesh.rank * b, (mesh.rank + 1) * b)


def shard_batch(mesh: Mesh, batch):
    """This rank's rows of a global host batch: a dict (or an array or
    tensor) whose leading dimension the mesh size divides."""
    if isinstance(batch, dict):
        return {k: shard_batch(mesh, v) for k, v in batch.items()}
    return batch[shard_rows(mesh, len(batch))]


# ---------------------------------------------------------------------------
# collectives

def _member(mesh: Mesh) -> None:
    if not mesh.member:
        raise RuntimeError("a rank outside the mesh issued a collective")


def all_gather(mesh: Mesh, x: torch.Tensor, dim: int = 0) -> torch.Tensor:
    """The ranks' ``x`` concatenated along ``dim`` in mesh order (JAX's
    tiled ``all_gather``)."""
    _member(mesh)
    COUNTS["all_gather"] += 1
    x = x.contiguous()
    parts = [torch.empty_like(x) for _ in range(mesh.size)]
    dist.all_gather(parts, x, group=mesh.group)
    return torch.cat(parts, dim=dim)


def all_reduce(mesh: Mesh, x: torch.Tensor, op: str = "sum"
               ) -> torch.Tensor:
    """``x`` reduced over the ranks in place ('sum', 'max' or 'mean');
    returns it."""
    _member(mesh)
    COUNTS["all_reduce"] += 1
    red = {"sum": dist.ReduceOp.SUM, "mean": dist.ReduceOp.SUM,
           "max": dist.ReduceOp.MAX}[op]
    dist.all_reduce(x, op=red, group=mesh.group)
    if op == "mean":
        x.div_(mesh.size)
    return x


def reduce_scatter(mesh: Mesh, x: torch.Tensor, dim: int = 0
                   ) -> torch.Tensor:
    """This rank's block, along ``dim``, of the sum of the ranks' ``x``.
    NCCL reduces and scatters in one collective; gloo, which has none,
    all-reduces and keeps the block."""
    _member(mesh)
    COUNTS["reduce_scatter"] += 1
    n = x.shape[dim] // mesh.size
    if dist.get_backend(mesh.group) == "nccl":
        src = x.movedim(dim, 0).contiguous()
        out = src.new_empty((n, *src.shape[1:]))
        dist.reduce_scatter_tensor(out, src, group=mesh.group)
        return out.movedim(0, dim)
    full = x.contiguous()
    dist.all_reduce(full, group=mesh.group)
    return full.narrow(dim, mesh.rank * n, n).clone()


def broadcast(mesh: Mesh, x: torch.Tensor, src: int = 0) -> torch.Tensor:
    """``x`` of mesh rank ``src`` on every rank, in place."""
    _member(mesh)
    COUNTS["broadcast"] += 1
    dist.broadcast(x, mesh.ranks[src], group=mesh.group)
    return x


def barrier(mesh: Mesh) -> None:
    _member(mesh)
    COUNTS["barrier"] += 1
    if dist.get_backend(mesh.group) == "nccl":
        dist.barrier(group=mesh.group, device_ids=[mesh.device.index])
    else:
        dist.barrier(group=mesh.group)


def broadcast_object(mesh: Mesh, obj=None, src: int = 0):
    """A picklable host object of mesh rank ``src`` on every rank (tensors
    inside it must be on the CPU). Its bytes go as a length, then a uint8
    tensor, on the mesh's device."""
    _member(mesh)
    data = pickle.dumps(obj) if mesh.rank == src else b""
    size = torch.tensor([len(data)], dtype=torch.int64, device=mesh.device)
    broadcast(mesh, size, src)
    buf = torch.empty(int(size.item()), dtype=torch.uint8, device=mesh.device)
    if mesh.rank == src:
        buf.copy_(torch.frombuffer(bytearray(data), dtype=torch.uint8))
    broadcast(mesh, buf, src)
    return obj if mesh.rank == src else \
        pickle.loads(buf.cpu().numpy().tobytes())


def share(mesh: Mesh | None, value=None):
    """The result a fitted mesh computed, on every rank of its parent: a
    no-op for a full mesh (or None); else mesh rank 0 broadcasts
    ``value`` (numpy arrays, tensors moved to the CPU and back to the
    rank's device, or other picklable objects) over the parent."""
    if mesh is None or mesh.parent is None:
        return value
    parent = mesh.parent
    src = parent.ranks.index(mesh.ranks[0])

    def to_host(v):
        if isinstance(v, torch.Tensor):
            return ("tensor", v.detach().cpu())
        if isinstance(v, tuple):
            return ("tuple", [to_host(x) for x in v])
        return ("plain", v)

    def to_dev(h):
        kind, v = h
        if kind == "tensor":
            return v.to(parent.device)
        if kind == "tuple":
            return tuple(to_dev(x) for x in v)
        return v

    packed = to_host(value) if parent.rank == src else None
    return to_dev(broadcast_object(parent, packed, src))


class _GatherWithGrad(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, dim):
        ctx.mesh, ctx.dim, ctx.n = mesh, dim, x.shape[dim]
        return all_gather(mesh, x, dim)

    @staticmethod
    def backward(ctx, g):
        g = all_reduce(ctx.mesh, g.contiguous())
        return g.narrow(ctx.dim, ctx.mesh.rank * ctx.n, ctx.n), None, None


def gather_with_grad(mesh: Mesh, x: torch.Tensor, dim: int = 0
                     ) -> torch.Tensor:
    """``all_gather`` with a gradient: each rank's loss may read every
    rank's rows, and the backward hands each rank the sum over the ranks
    of the gradients of its own rows."""
    return _GatherWithGrad.apply(x, mesh, dim)


def pad_rows(x, n_dev: int):
    """``x`` (array or tensor) with zero rows appended up to a multiple of
    ``n_dev``; returns (padded, the original row count)."""
    n = len(x)
    pad = (-n) % n_dev
    if not pad:
        return x, n
    if isinstance(x, torch.Tensor):
        return torch.cat([x, x.new_zeros((pad, *x.shape[1:]))]), n
    return np.concatenate([x, np.zeros((pad, *x.shape[1:]), x.dtype)]), n


def init_process_group(rank: int, world: int, *, device: str,
                       init_method: str, timeout_s: float = 600.0) -> None:
    """Join a process group of ``world`` ranks: NCCL on card ``rank`` when
    ``device`` is 'cuda', gloo when it is 'cpu'."""
    if device == "cuda":
        torch.cuda.set_device(rank % torch.cuda.device_count())
    dist.init_process_group(
        "nccl" if device == "cuda" else "gloo", init_method=init_method,
        rank=rank, world_size=world,
        timeout=datetime.timedelta(seconds=timeout_s))


def env_world() -> tuple[int, int, int] | None:
    """(rank, world size, local rank) from a ``torchrun`` environment, or
    None outside one."""
    if "RANK" not in os.environ or "WORLD_SIZE" not in os.environ:
        return None
    rank = int(os.environ["RANK"])
    return (rank, int(os.environ["WORLD_SIZE"]),
            int(os.environ.get("LOCAL_RANK", rank)))
