"""Ranks, meshes and collectives: the port's distributed backend
(counterpart of egopose_tpu/parallel/mesh.py).

The JAX package runs data parallelism as GSPMD in one process: arrays are
sharded over a device mesh and XLA inserts the collectives.  The port is
SPMD, PyTorch's own idiom: one process per rank, each holding its shard
of the lanes, every global quantity made explicit by a collective over
``torch.distributed``.

- ``launch(n, fn, *args)`` runs ``fn`` in n ranks with the process group
  up (rendezvous through a FileStore in a temporary directory, so
  concurrent runs never collide on a port).  NCCL when each rank has a
  card of its own (rank r on ``cuda:r``), gloo for CPU ranks and for
  ranks that share cards (``device_ids``).
- ``make_mesh`` / ``make_mesh_2d`` name the ranks' axes on
  ``torch.distributed.device_mesh``, inside the ranks.  On CUDA they raise
  when fewer cards are visible than ranks asked for, as the JAX
  ``make_mesh`` does: silently truncating would let multi-chip claims
  pass.
- Every collective of the port runs through this module (a test greps for
  it), and each is noted for parallel/audit.py.  Under gloo a collective
  on a CUDA tensor is staged through a host buffer: gloo reduces host
  memory, so the rule is fixed by the backend, not tried and caught.
"""
from __future__ import annotations

import copy
import datetime
import os
import pickle
import shutil
import tempfile

import torch
import torch.distributed as dist

from . import audit

TIMEOUT = datetime.timedelta(minutes=15)


def check_devices(n: int, device, device_ids=None):
    """Raise when ``n`` ranks on CUDA would not each find a card: fewer
    visible than ``n`` (without ``device_ids``), or ``device_ids`` naming
    one that is not there."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type != "cuda":
        return
    count = torch.cuda.device_count() if torch.cuda.is_available() else 0
    if device_ids is not None:
        if len(device_ids) != n or any(not 0 <= i < count
                                       for i in device_ids):
            raise RuntimeError(
                f"device_ids={list(device_ids)} for {n} ranks: {count} CUDA "
                "device(s) visible")
    elif count < n:
        raise RuntimeError(
            f"make_mesh({n}): only {count} CUDA device(s) visible; run the "
            f"ranks on the CPU instead (device='cpu', --device cpu: gloo "
            f"ranks), or share cards explicitly with make_mesh({n}, "
            f"device_ids=[...])")


def _backend(device, device_ids) -> str:
    dev = torch.device("cuda" if device is None else device)
    return "nccl" if dev.type == "cuda" and device_ids is None else "gloo"


def _card(rank: int, device_ids) -> int:
    return rank if device_ids is None else device_ids[rank]


def to_cpu(x):
    """``x`` with every tensor in it (dicts, lists, tuples) on the CPU."""
    if torch.is_tensor(x):
        return x.detach().cpu()
    if isinstance(x, dict):
        return {k: to_cpu(v) for k, v in x.items()}
    if isinstance(x, (list, tuple)) and not hasattr(x, "_fields"):
        return type(x)(to_cpu(v) for v in x)
    return x


def _rank_main(rank, n, backend, run_dir, device, device_ids, dtype, fn,
               args):
    """One rank: its card, the process group, ``fn``.  A spawned rank runs
    one torch thread (n ranks share the host's cores) with the launching
    process's default dtype (its modules are made as that process would
    make them), copies its arguments first (torch.multiprocessing hands
    every rank the same shared-memory tensors, which an in-place update
    would write for all) and pickles its result into ``run_dir``."""
    if n > 1:
        torch.set_num_threads(1)
        torch.set_default_dtype(dtype)
        args = copy.deepcopy(args)
    if torch.device(device).type == "cuda":
        torch.cuda.set_device(_card(rank, device_ids))
    store = dist.FileStore(os.path.join(run_dir, "store"), n)
    dist.init_process_group(backend, store=store, rank=rank, world_size=n,
                            timeout=TIMEOUT)
    try:
        out = fn(*args)
        if n > 1:
            with open(os.path.join(run_dir, f"result{rank}.p"), "wb") as f:
                pickle.dump(to_cpu(out), f)
        return out
    finally:
        dist.destroy_process_group()


def launch(n: int, fn, *args, device="cpu", device_ids=None):
    """Run ``fn(*args)`` in ``n`` ranks with the default process group up
    and return each rank's result (tensors moved to the CPU).  One rank
    runs in this process (its result as it is); more are spawned.
    ``device_ids`` (cards, one per rank) lets ranks share a card under
    gloo."""
    check_devices(n, device, device_ids)
    backend = _backend(device, device_ids)
    run_dir = tempfile.mkdtemp(prefix="egopose_ranks_")
    try:
        if n == 1:
            return [_rank_main(0, 1, backend, run_dir, device, device_ids,
                               None, fn, args)]
        torch.multiprocessing.spawn(
            _rank_main, args=(n, backend, run_dir, device, device_ids,
                              torch.get_default_dtype(), fn, args),
            nprocs=n, join=True)
        out = []
        for r in range(n):
            with open(os.path.join(run_dir, f"result{r}.p"), "rb") as f:
                out.append(pickle.load(f))
        return out
    finally:
        shutil.rmtree(run_dir, ignore_errors=True)


def _main_quietly(main, argv):
    main(argv)


def in_ranks() -> bool:
    """True inside a rank: a process group is up, or torchrun started this
    process (``WORLD_SIZE`` set), in which case its group is joined."""
    if not dist.is_initialized() and "WORLD_SIZE" in os.environ:
        dist.init_process_group(timeout=TIMEOUT)
    return dist.is_initialized()


def run_cli(n: int, main, argv, *hooks, device=None):
    """A CLI's ``--dp-devices`` / ``--sp-devices``: ``main`` re-entered in
    ``n`` ranks with ``argv``.  One rank runs in this process with
    ``hooks`` and returns what ``main`` returns; more are spawned and
    return None (their results stay on disk, where main writes them)."""
    if n == 1:
        return launch(1, main, argv, *hooks, device=device)[0]
    launch(n, _main_quietly, main, argv, device=device)
    return None


class Mesh:
    """The ranks' named axes (a ``DeviceMesh``), this rank's device and
    whether its collectives are staged through host memory."""

    def __init__(self, device_mesh, axis_names, shape, device, staged):
        self.device_mesh = device_mesh
        self.axis_names = tuple(axis_names)
        self.shape = dict(zip(self.axis_names, shape))
        self.device = device
        self.staged = staged

    def size(self, axis) -> int:
        """The ranks along ``axis`` (a name, or a tuple of names)."""
        out = 1
        for a in _axes(axis):
            out *= self.shape[a]
        return out

    def rank(self, axis: str) -> int:
        """This rank's index along ``axis``."""
        return self.device_mesh.get_local_rank(axis)

    def group(self, axis):
        """The process group of ``axis`` (a name, or a tuple of names)."""
        axes = _axes(axis)
        if set(axes) == set(self.axis_names):
            return dist.group.WORLD
        (a,) = axes
        return self.device_mesh.get_group(a)

    @property
    def lead(self) -> bool:
        """The rank that logs and writes files."""
        return dist.get_rank() == 0


def _axes(axis) -> tuple:
    return (axis,) if isinstance(axis, str) else tuple(axis)


def _mesh(shape, axes, device, device_ids) -> Mesh:
    n = 1
    for s in shape:
        n *= s
    check_devices(n, device, device_ids)
    if not in_ranks():
        raise RuntimeError(
            f"a {'x'.join(map(str, shape))} mesh needs {n} ranks with the "
            "process group up: run them with parallel.mesh.launch (or "
            "torchrun)")
    if dist.get_world_size() != n:
        raise RuntimeError(f"mesh of {n} ranks in a world of "
                           f"{dist.get_world_size()}")
    from torch.distributed.device_mesh import init_device_mesh
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda":
        dev = torch.device("cuda", _card(dist.get_rank(), device_ids))
    staged = dist.get_backend() == "gloo" and dev.type == "cuda"
    dm = init_device_mesh("cuda" if dev.type == "cuda" and not staged
                          else "cpu", tuple(shape), mesh_dim_names=axes)
    return Mesh(dm, axes, shape, dev, staged)


def make_mesh(n_devices: int, axis: str = "data", device=None,
              device_ids=None) -> Mesh:
    """A 1-D mesh over the ``n_devices`` ranks of the running group, on
    ``device`` (default cuda: rank r on cuda:r, or on
    ``device_ids[r]``)."""
    return _mesh((n_devices,), (axis,), device, device_ids)


def make_mesh_2d(dp: int, sp: int, axes: tuple = ("data", "time"),
                 device=None, device_ids=None) -> Mesh:
    """A (dp x sp) mesh: rollout lanes and update batches split over
    ``axes[0]``, the sequence-parallel context encode over ``axes[1]``
    (parallel/seqpar.py).  Ranks r = i * sp + j sit at (i, j)."""
    return _mesh((dp, sp), tuple(axes), device, device_ids)


# -- collectives ----------------------------------------------------------

def _run(mesh, fn, x: torch.Tensor) -> torch.Tensor:
    """``fn`` on ``x``, through a host copy when the mesh is staged."""
    if not mesh.staged:
        fn(x)
        return x
    host = x.cpu()
    fn(host)
    return host.to(x.device)


_OPS = {"sum": dist.ReduceOp.SUM, "max": dist.ReduceOp.MAX,
        "min": dist.ReduceOp.MIN}


def all_reduce(mesh: Mesh, x: torch.Tensor, axis, op: str = "sum"):
    """``x`` reduced (sum, max or min) over the ranks of ``axis``; a new
    tensor, ``x`` unchanged."""
    group = mesh.group(axis)
    out = _run(mesh, lambda t: dist.all_reduce(t, _OPS[op], group=group),
               x.detach().clone().contiguous())
    audit.note("all-reduce", out, mesh.size(axis))
    return out


def all_reduce_sum(mesh: Mesh, x: torch.Tensor, axis) -> torch.Tensor:
    return all_reduce(mesh, x, axis, "sum")


def all_gather(mesh: Mesh, x: torch.Tensor, axis) -> list:
    """Every rank's ``x`` along ``axis``, in rank order."""
    group = mesh.group(axis)
    n = mesh.size(axis)
    src = x.detach().contiguous()
    if mesh.staged:
        src = src.cpu()
    parts = [torch.empty_like(src) for _ in range(n)]
    dist.all_gather(parts, src, group=group)
    out = torch.stack(parts)
    audit.note("all-gather", out, n)
    return list(out.to(x.device).unbind(0))


def broadcast(mesh: Mesh, x: torch.Tensor, axis=None) -> torch.Tensor:
    """``x`` of the axis group's first rank, on every rank (the whole
    mesh without ``axis``), copied into ``x`` in place."""
    axis = mesh.axis_names if axis is None else axis
    group = mesh.group(axis)
    src = dist.get_global_rank(group, 0) if group is not dist.group.WORLD \
        else 0
    out = _run(mesh, lambda t: dist.broadcast(t, src, group=group),
               x.detach().contiguous())
    with torch.no_grad():
        x.copy_(out)
    audit.note("broadcast", out, mesh.size(axis))
    return x


def barrier(mesh: Mesh):
    """Every rank waits for all: after the lead rank writes a file the
    others read."""
    dist.barrier(group=mesh.group(mesh.axis_names))


def lead_writes(mesh, write, *args):
    """``write(*args)`` on the lead rank (in the one process without a
    mesh), then every rank waits for it."""
    if mesh is None or mesh.lead:
        write(*args)
    if mesh is not None:
        barrier(mesh)


class AllReduceSum(torch.autograd.Function):
    """Differentiable sum over the ranks of an axis: each rank's loss
    depends on the sum, so the gradient of each rank's input is the sum of
    every rank's upstream gradient -- itself an all-reduce."""

    @staticmethod
    def forward(ctx, x, mesh, axis):
        ctx.mesh, ctx.axis = mesh, axis
        return all_reduce_sum(mesh, x, axis)

    @staticmethod
    def backward(ctx, g):
        return all_reduce_sum(ctx.mesh, g, ctx.axis), None, None


class Group:
    """One axis of a mesh as a reducer: ``sum`` of a tensor over its
    ranks (the global batch of ops/running_norm.py, the losses'
    denominators), ``sum_grad`` the same, differentiable."""

    def __init__(self, mesh: Mesh, axis):
        self.mesh, self.axis = mesh, axis

    def sum(self, x: torch.Tensor) -> torch.Tensor:
        return all_reduce_sum(self.mesh, x, self.axis)

    def sum_grad(self, x: torch.Tensor) -> torch.Tensor:
        return AllReduceSum.apply(x, self.mesh, self.axis)


def all_reduce_grads(mesh, grads, params, wide=()) -> list:
    """The gradients ``grads`` of ``params`` summed over the ranks, None
    made zeros first so that a rank without lanes still joins: one flat
    all-reduce over the mesh's first (lanes') axis, and one over every
    axis for the parameters in ``wide`` (ids of the time-sharded context
    nets' parameters).  Without a mesh, only the zeros."""
    grads = [torch.zeros_like(p) if g is None else g
             for p, g in zip(params, grads)]
    if mesh is None:
        return grads
    for axis, keep in ((mesh.axis_names[0], False),
                       (mesh.axis_names, True)):
        idx = [i for i, p in enumerate(params) if (id(p) in wide) == keep]
        if not idx:
            continue
        flat = all_reduce_sum(
            mesh, torch.cat([grads[i].reshape(-1) for i in idx]), axis)
        for i, g in zip(idx, flat.split([grads[i].numel() for i in idx])):
            grads[i] = g.view_as(grads[i])
    return grads


# -- shards ---------------------------------------------------------------

def lane_slice(mesh: Mesh, x: torch.Tensor, axis: str = "data",
               dim: int = 0) -> torch.Tensor:
    """This rank's contiguous shard of ``x`` along ``dim`` (the
    counterpart of shard_batch / lane_sharding)."""
    n = mesh.size(axis)
    size = x.shape[dim]
    if size % n:
        raise ValueError(f"{size} lanes not divisible by the {axis!r} mesh "
                         f"axis ({n})")
    k = size // n
    return x.narrow(dim, mesh.rank(axis) * k, k)


def gather_lanes(mesh: Mesh, x: torch.Tensor, axis: str = "data",
                 dim: int = 0, segments: int = 1) -> torch.Tensor:
    """The whole of ``x`` on every rank, from each rank's ``lane_slice``
    along ``dim`` of each of ``segments`` segments laid one after another
    there (a sampled batch's layout), in the one-process lane order: one
    all-gather over ``axis``."""
    parts = all_gather(mesh, x, axis)
    k = x.shape[dim] // segments
    split = [*x.shape[:dim], segments, k, *x.shape[dim + 1:]]
    out = torch.stack([t.reshape(split) for t in parts], dim + 1)
    return out.reshape(*x.shape[:dim], segments * len(parts) * k,
                       *x.shape[dim + 1:])


def replicate(mesh: Mesh, tree):
    """Rank 0's modules or tensors on every rank (broadcast in place;
    a module's parameters and buffers); returns ``tree``."""
    items = tree if isinstance(tree, (list, tuple)) else [tree]
    for item in items:
        tensors = item.state_dict().values() \
            if isinstance(item, torch.nn.Module) else [item]
        for t in tensors:
            broadcast(mesh, t)
    return tree
