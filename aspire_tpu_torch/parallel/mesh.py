"""Process groups as a mesh: one rank a shard or a data replica (counterpart
of aspire_tpu/parallel/mesh.py).

The JAX package runs one controller over a device mesh and lets XLA insert the
collectives.  Here every rank is a process with its own device, as the
reference's DDP was (main_fsim.py:36-46): `initialize_multihost` joins the
process group, `make_mesh` / `make_serving_mesh` / `make_train_serve_mesh`
lay the ranks out on named axes with one process group an axis, and the code
that runs on a mesh calls the collectives itself (`all_gather`, `all_reduce`,
`broadcast`: the three that both NCCL and gloo take on CUDA tensors).

Every rank streams the SAME data, as the JAX package's processes do
(`mesh.py:29-33` there): `place` and `shard_batch` give this rank its slice of
a host value, `replicate` broadcasts rank 0's tensors.  No per-rank data files.

Backends, with no silent fallback:

  * "nccl" is the default for a CUDA device.  Each rank takes
    ``cuda:{local rank}``; two ranks on one card are refused.
  * "gloo" runs only when it is asked for (or on the CPU, where it is the
    only backend): the CPU tests, and a rehearsal on one card with the ranks
    sharing ``cuda:0`` (``colocate=True``).

`run_ranks` spawns the ranks of one machine and returns what each returned;
the CLI's ``--num-devices`` / ``--n-shards`` and the tests use it.
"""
from __future__ import annotations

import dataclasses
import os
import pathlib
import socket
import tempfile

import numpy as np
import torch
import torch.distributed as dist

from ..core.types import require_device

_rank_device: torch.device | None = None


@dataclasses.dataclass(frozen=True)
class Mesh:
    """The ranks laid out on named axes.

    axis_names: e.g. ("data",), ("shard",) or ("data", "shard");
    shape: ranks along each axis (their product is the world size);
    rank: this process's global rank (row-major over `shape`);
    device: this rank's device;
    groups: one process group an axis, holding the ranks that share every
        other coordinate with this one.
    """

    axis_names: tuple
    shape: tuple
    rank: int
    device: torch.device
    groups: dict
    backend: str

    @property
    def world_size(self) -> int:
        return int(np.prod(self.shape))

    def size(self, axis: str) -> int:
        return self.shape[self.axis_names.index(axis)]

    def index(self, axis: str) -> int:
        """This rank's coordinate along `axis`."""
        coords = np.unravel_index(self.rank, self.shape)
        return int(coords[self.axis_names.index(axis)])

    def group(self, axis: str):
        return self.groups[axis]


def _init_method(coordinator: str) -> str:
    if coordinator.startswith(("file://", "tcp://", "env://")):
        return coordinator
    return f"tcp://{coordinator}"


def _rank_device_for(device, process_id: int, colocate: bool) -> torch.device:
    dev = require_device(device)
    if dev.type != "cuda":
        return dev
    if colocate:
        return torch.device("cuda", 0)
    local = int(os.environ.get("LOCAL_RANK", process_id))
    count = torch.cuda.device_count()
    if local >= count:
        raise ValueError(
            f"rank {process_id} would take cuda:{local}, but this host has "
            f"{count} card(s): run at most {count} ranks a host (LOCAL_RANK "
            "names a rank's card), or ask for ranks that share a card "
            "(colocate, gloo only)")
    return torch.device("cuda", local)


def initialize_multihost(coordinator: str, num_processes: int,
                         process_id: int, backend: str | None = None,
                         device="cuda", colocate: bool = False
                         ) -> torch.device:
    """Join the process group as rank `process_id` of `num_processes`; returns
    this rank's device, which the mesh builders then take (the process's
    one group and device, as torch.distributed keeps one default group).

    coordinator: "host:port" of rank 0 (a tcp:// init method), or a full init
        method such as "file:///tmp/x" (what `run_ranks` uses, so that jobs
        side by side never share a port).
    backend: "nccl" (the default on CUDA) or "gloo" (the default, and the only
        one, on the CPU).  nccl refuses ranks that would share a card.
    colocate: every rank on cuda:0 (gloo only): a rehearsal of several ranks
        on one card.
    """
    global _rank_device
    dev = torch.device(device)
    if backend is None:
        backend = "nccl" if dev.type == "cuda" else "gloo"
    if backend not in ("nccl", "gloo"):
        raise ValueError(f"backend must be 'nccl' or 'gloo', got {backend!r}")
    if backend == "nccl" and dev.type != "cuda":
        raise ValueError("the nccl backend needs CUDA devices; the CPU takes "
                         "backend='gloo'")
    if backend == "nccl" and colocate and num_processes > 1:
        raise ValueError("nccl takes one rank a card: ranks that share a card "
                         "need backend='gloo'")
    rank_dev = _rank_device_for(dev, process_id, colocate)
    if rank_dev.type == "cuda":
        torch.cuda.set_device(rank_dev)
    dist.init_process_group(
        backend, init_method=_init_method(coordinator),
        world_size=num_processes, rank=process_id,
        device_id=rank_dev if backend == "nccl" else None)
    if backend == "nccl" and num_processes > 1:
        seen = [None] * num_processes
        dist.all_gather_object(seen, (socket.gethostname(), rank_dev.index))
        if len(set(seen)) < num_processes:
            dist.destroy_process_group()
            raise ValueError(f"two nccl ranks share a card: {seen}")
    _rank_device = rank_dev
    return rank_dev


def _build_mesh(axis_names: tuple, shape: tuple) -> Mesh:
    if not dist.is_initialized() or _rank_device is None:
        raise RuntimeError("no process group: call initialize_multihost (or "
                           "run under run_ranks) before building a mesh")
    world, rank = dist.get_world_size(), dist.get_rank()
    groups = {}
    ranks = np.arange(world).reshape(shape)
    for ax in range(len(shape)):
        # every rank creates every group of the axis, in the same order
        lines = np.moveaxis(ranks, ax, -1).reshape(-1, shape[ax])
        for line in lines:
            members = [int(r) for r in line]
            group = (dist.group.WORLD if len(members) == world
                     else dist.new_group(members))
            if rank in members:
                groups[axis_names[ax]] = group
    return Mesh(axis_names=tuple(axis_names), shape=tuple(shape), rank=rank,
                device=_rank_device, groups=groups,
                backend=dist.get_backend())


def _check_world(n, what: str) -> int:
    world = dist.get_world_size() if dist.is_initialized() else 1
    if n is None:
        return world
    if world < n:
        raise ValueError(f"requested {n} {what}, only {world} available")
    if world > n:
        raise ValueError(f"requested {n} {what}, but the process group has "
                         f"{world} ranks: a rank outside the mesh would have "
                         "nothing to do")
    return n


def make_mesh(n_data: int | None = None) -> Mesh:
    """1-D data-parallel mesh ("data",) over the process group's ranks."""
    n = _check_world(n_data, "data-parallel devices")
    return _build_mesh(("data",), (n,))


def make_serving_mesh(n_shards: int | None = None) -> Mesh:
    """1-D corpus-sharding mesh ("shard",) for index serving."""
    n = _check_world(n_shards, "index shards")
    return _build_mesh(("shard",), (n,))


def make_train_serve_mesh(n_data: int, n_shards: int) -> Mesh:
    """2-D mesh ("data", "shard") for colocated training + serving jobs."""
    _check_world(n_data * n_shards, "data x shard devices")
    return _build_mesh(("data", "shard"), (n_data, n_shards))


def local_slice(n: int, mesh: Mesh, axis: str) -> slice:
    """This rank's contiguous part of `n` rows split evenly over `axis`."""
    ranks, i = mesh.size(axis), mesh.index(axis)
    if n % ranks:
        raise ValueError(f"{n} rows do not split over the {ranks} ranks of "
                         f"axis {axis!r}")
    step = n // ranks
    return slice(i * step, (i + 1) * step)


def place(x, mesh: Mesh, spec: tuple = ()) -> torch.Tensor:
    """This rank's part of a host value, on its device.

    spec names a mesh axis (or None) for each leading dimension, as a JAX
    PartitionSpec does: () replicates, ("shard",) gives this rank its
    contiguous slice of dim 0 over the shard axis, (None, "data") of dim 1
    over the data axis.  Every rank passes the same full value."""
    t = torch.as_tensor(np.asarray(x) if not isinstance(x, torch.Tensor) else x)
    for dim, axis in enumerate(spec):
        if axis is not None:
            part = local_slice(t.shape[dim], mesh, axis)
            t = t.narrow(dim, part.start, part.stop - part.start)
    return t.contiguous().to(mesh.device)


def shard_batch(batch, mesh: Mesh, axis: int = 0):
    """This rank's rows of every array of a batch tree, split along `axis`
    over the data axis: axis=0 for flat [batch, ...] trees, axis=1 for
    accumulation superbatches [n_micro, micro_batch, ...]."""
    spec = (None,) * axis + ("data",)
    if isinstance(batch, dict):
        return {k: shard_batch(v, mesh, axis) for k, v in batch.items()}
    return place(batch, mesh, spec)


@torch.no_grad()
def replicate(tree, mesh: Mesh):
    """Rank 0's values on every rank: the parameters and buffers of a module
    (in place) or the tensors of a nested dict (returned).  One broadcast a
    tensor over the whole mesh."""
    if isinstance(tree, torch.nn.Module):
        for t in tree.state_dict().values():
            dist.broadcast(t, src=0)
        return tree
    if isinstance(tree, dict):
        return {k: replicate(v, mesh) for k, v in tree.items()}
    t = torch.as_tensor(tree).to(mesh.device).contiguous()
    dist.broadcast(t, src=0)
    return t


class _GatherRows(torch.autograd.Function):
    """all_gather along dim 0 whose backward is a SUM all_reduce of the whole
    gradient, of which this rank keeps its own rows: every rank's loss may
    reach every rank's rows (in-batch negatives), and the sum over ranks of
    those gradients is each row's gradient."""

    @staticmethod
    def forward(ctx, x, group, n, index):
        ctx.group, ctx.rows, ctx.index = group, x.shape[0], index
        parts = [torch.empty_like(x) for _ in range(n)]
        dist.all_gather(parts, x.contiguous(), group=group)
        return torch.cat(parts)

    @staticmethod
    def backward(ctx, g):
        g = g.contiguous().clone()
        dist.all_reduce(g, op=dist.ReduceOp.SUM, group=ctx.group)
        first = ctx.index * ctx.rows
        return g[first:first + ctx.rows], None, None, None


def gather_rows(x: torch.Tensor, mesh: Mesh, axis: str = "data"):
    """Every rank's rows of x, in rank order along `axis`: [n * rows, ...].
    Differentiable for floating tensors (gathered in float32: bf16 casts there
    and back exactly, and not every backend reduces bf16); integer tensors
    are gathered as they are."""
    group, n, index = mesh.group(axis), mesh.size(axis), mesh.index(axis)
    if x.is_floating_point():
        return _GatherRows.apply(x.float(), group, n, index).to(x.dtype)
    parts = [torch.empty_like(x) for _ in range(n)]
    dist.all_gather(parts, x.contiguous(), group=group)
    return torch.cat(parts)


def all_reduce(x: torch.Tensor, mesh: Mesh, axis: str = "data",
               op=dist.ReduceOp.SUM) -> torch.Tensor:
    """x reduced over `axis` (in float32 for floating x, returned in x's
    dtype); a new tensor, x is left as it is."""
    y = x.float().clone() if x.is_floating_point() else x.clone()
    dist.all_reduce(y, op=op, group=mesh.group(axis))
    return y.to(x.dtype)


def _rank_main(local: int, fn, n_local: int, init: str, num_processes: int,
               process_id: int, backend, device, colocate: bool, out_dir: str,
               args) -> None:
    os.environ["LOCAL_RANK"] = str(local)
    rank = process_id * n_local + local
    initialize_multihost(init, num_processes * n_local, rank, backend=backend,
                         device=device, colocate=colocate)
    try:
        result = fn(*args)
        torch.save(result, pathlib.Path(out_dir) / f"rank{local}.pt")
        dist.barrier()
    finally:
        dist.destroy_process_group()


def run_ranks(fn, n_local: int, *args, device="cuda",
              backend: str | None = None, colocate: bool = False,
              coordinator: str | None = None, num_processes: int = 1,
              process_id: int = 0) -> list:
    """Spawn `n_local` ranks on this machine; each joins the process group
    and returns fn(*args).  Returns the local ranks' results in order (each
    saved with torch.save and loaded here, on the CPU).  fn must be
    importable by name: the ranks are spawned, not forked.  A rank that
    raises fails the whole run.

    One machine (the default): the group is these ranks, met through a
    file:// init method in a fresh temporary directory, so that jobs side by
    side never share a port.  Several machines: run the same command on each
    with its `process_id` of `num_processes` and rank 0's `coordinator`
    ("host:port"); machine p holds global ranks p * n_local .. + n_local - 1,
    local rank j on cuda:j."""
    import torch.multiprocessing as tmp

    if num_processes > 1 and coordinator is None:
        raise ValueError("several machines need the coordinator's host:port")
    with tempfile.TemporaryDirectory(prefix="aspire_ranks_") as tmpdir:
        init = coordinator or "file://" + str(pathlib.Path(tmpdir) / "rendezvous")
        tmp.spawn(_rank_main, nprocs=n_local, join=True,
                  args=(fn, n_local, init, num_processes, process_id, backend,
                        str(device), colocate, tmpdir, args))
        return [torch.load(pathlib.Path(tmpdir) / f"rank{r}.pt",
                           map_location="cpu", weights_only=False)
                for r in range(n_local)]
