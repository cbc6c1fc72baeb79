"""Data parallel over processes (port of gaussianip_tpu/parallel/mesh.py).

The JAX package shards the camera / view batch over a 1-D 'data' mesh: a
sharded array is still one global array, so every reduction over the batch
stays global and XLA inserts the psum on the parameter gradients. Here each
rank is a process (torch.distributed) that holds only its own rows, so every
reduction over the batch is a collective, written out where it happens:

  * `DataGroup` (make_data_mesh): rank, world size, the rank's device and
    process group. `group=None` everywhere is a single process, which runs
    the code it ran before data parallel existed.
  * `row_span` / `local_rows` (shard_over_data, put_sharded): the rank's
    contiguous rows of axis 0, the split of P("data").
  * `replicated`: every tensor broadcast from the group's rank 0, for the
    initial state and a state loaded from disk.
  * `all_sum`, `all_sum_many`, `all_max`, `gather_rows`, `barrier`: the
    collectives, one path for NCCL and gloo, CPU and CUDA tensors. gloo
    has no all_gather for CUDA tensors, so the gather is an
    all_reduce(SUM) of a zero-filled full-size buffer into which each rank
    writes its own rows; x + 0 is exact, so the gather is too.
  * `global_max`: the max over every rank's elements, whose gradient
    reaches only the elements that hold it, split evenly among ties across
    ranks, as jnp.max's and torch.max's is.
  * `state_digest` / `check_replicated`: the replicated state is
    bit-identical on every rank; this checks it rather than assuming it.
  * `spawn`: N ranks as processes, one device each.
"""

from __future__ import annotations

import dataclasses
import datetime
import glob
import os
import shutil
import socket
import tempfile
import traceback
from dataclasses import dataclass

import torch
import torch.distributed as dist
from torch.multiprocessing.spawn import ProcessException


@dataclass(frozen=True)
class DataGroup:
    """One rank's view of the data-parallel group."""

    rank: int
    world_size: int
    device: torch.device
    pg: object = None  # the ProcessGroup; None: the default group

    @property
    def src(self) -> int:
        """The global rank of the group's rank 0."""
        return 0 if self.pg is None else dist.get_global_rank(self.pg, 0)


def world_size(group) -> int:
    return 1 if group is None else group.world_size


def is_main(group) -> bool:
    """True on the rank that writes files (rank 0, or a single process)."""
    return group is None or group.rank == 0


def _walk(fn, tree, name=""):
    """The tree rebuilt with fn(name, leaf) in place of every leaf that is
    not a dict, list, tuple, NamedTuple or dataclass; name is the leaf's
    path (".field", "[i]")."""
    if isinstance(tree, dict):
        return {k: _walk(fn, v, f"{name}.{k}") for k, v in tree.items()}
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return type(tree)(*(_walk(fn, v, f"{name}.{k}")
                            for k, v in zip(tree._fields, tree)))
    if isinstance(tree, (list, tuple)):
        return type(tree)(_walk(fn, v, f"{name}[{i}]")
                          for i, v in enumerate(tree))
    if dataclasses.is_dataclass(tree) and not isinstance(tree, type):
        return dataclasses.replace(tree, **{
            f.name: _walk(fn, getattr(tree, f.name), f"{name}.{f.name}")
            for f in dataclasses.fields(tree)})
    return fn(name, tree)


def tree_map(fn, tree):
    """fn on every tensor of a tree of dicts, lists, tuples, NamedTuples and
    dataclasses; other leaves are kept."""
    return _walk(lambda _, x: fn(x) if isinstance(x, torch.Tensor) else x,
                 tree)


def row_span(group, n: int) -> tuple[int, int]:
    """[lo, hi) of the rank's rows among n: contiguous and balanced, equal
    shares when the world size divides n."""
    if group is None:
        return 0, n
    w, r = group.world_size, group.rank
    return r * n // w, (r + 1) * n // w


def local_rows(group, tree):
    """The rank's rows of axis 0 of every tensor of `tree` (P("data")).
    Raises when a tensor's rows do not divide over the ranks."""
    if group is None:
        return tree

    def take(x):
        if x.shape[0] % group.world_size:
            raise ValueError(f"local_rows: {x.shape[0]} rows do not divide "
                             f"over {group.world_size} ranks")
        lo, hi = row_span(group, x.shape[0])
        return x[lo:hi]

    return tree_map(take, tree)


def _dense(x):
    return x.detach().clone(memory_format=torch.contiguous_format)


def replicated(group, tree):
    """Every tensor of `tree` as rank 0 holds it (a broadcast), as new
    tensors; every rank passes a tree of the same structure and shapes."""
    if group is None:
        return tree

    def bcast(x):
        y = _dense(x)
        dist.broadcast(y, group.src, group=group.pg)
        return y

    return tree_map(bcast, tree)


def all_sum(group, x):
    """The sum of x over the ranks (a new tensor; x itself with no
    group)."""
    if group is None:
        return x
    y = _dense(x)
    dist.all_reduce(y, dist.ReduceOp.SUM, group=group.pg)
    return y


def all_sum_many(group, tensors):
    """all_sum of each tensor (one dtype), in one collective."""
    if group is None:
        return list(tensors)
    flat = all_sum(group, torch.cat([x.reshape(-1) for x in tensors]))
    out, i = [], 0
    for x in tensors:
        out.append(flat[i:i + x.numel()].view(x.shape))
        i += x.numel()
    return out


def all_max(group, x):
    """The elementwise max of x over the ranks; bool is any()."""
    if group is None:
        return x
    y = _dense(x.to(torch.uint8) if x.dtype == torch.bool else x)
    dist.all_reduce(y, dist.ReduceOp.MAX, group=group.pg)
    return y.bool() if x.dtype == torch.bool else y


def gather_rows(group, x, n: int):
    """x: the rank's rows row_span(group, n) of an [n, ...] array -> the
    whole array on every rank."""
    if group is None:
        return x
    lo, hi = row_span(group, n)
    if x.shape[0] != hi - lo:
        raise ValueError(f"gather_rows: rank {group.rank} holds "
                         f"{x.shape[0]} rows, not {hi - lo} of {n}")
    buf = x.new_zeros((n,) + tuple(x.shape[1:]))
    buf[lo:hi] = x
    dist.all_reduce(buf, dist.ReduceOp.SUM, group=group.pg)
    return buf


def barrier(group):
    """Every rank waits here for the others (a one-element all_sum, the
    same on NCCL and gloo)."""
    if group is not None:
        all_sum(group, torch.zeros(1, device=group.device))


class _GlobalMax(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        m = all_max(group, x.detach().amax())
        hit = x.detach() == m
        count = all_sum(group, hit.sum().to(x.dtype))
        ctx.group = group
        ctx.save_for_backward(hit, count)
        return m

    @staticmethod
    def backward(ctx, g):
        # every rank's loss share depends on the max: its gradient is the
        # sum of theirs, split over every element that holds the max
        hit, count = ctx.saved_tensors
        return hit * (all_sum(ctx.group, g) / count), None


def global_max(group, x):
    """max(x) over every rank's elements, differentiable: the gradient of
    the max goes to the elements equal to it, each 1 / (their count over
    all ranks) of the summed upstream gradient (jnp.max's rule)."""
    if group is None:
        return x.max()
    return _GlobalMax.apply(x, group)


_BITS = {1: torch.uint8, 2: torch.int16, 4: torch.int32, 8: torch.int64}


def state_digest(tree) -> tuple[list, torch.Tensor]:
    """(leaf names, int64 digests): each tensor's bit patterns summed with
    position weights (a changed bit or a moved row changes it), each int as
    it is. Integer sums wrap the same in any order, so equal trees give
    equal digests on every rank."""
    names, vals, dev = [], [], None

    def add(name, x):
        nonlocal dev
        if isinstance(x, torch.Tensor):
            dev = x.device
            b = x.detach().contiguous().reshape(-1)
            b = b.view(_BITS[b.element_size()]).to(torch.int64)
            w = torch.arange(b.numel(), device=b.device) % 65521 + 1
            names.append(name)
            vals.append((b * w).sum())
        elif isinstance(x, int):  # bools too
            names.append(name)
            vals.append(torch.tensor(int(x), dtype=torch.int64))
        return x

    _walk(add, tree)
    return names, torch.stack([v.to(dev or "cpu") for v in vals])


def check_replicated(group, tree, what: str = "state"):
    """Raise on every rank when the ranks' trees are not bit-identical."""
    if group is None:
        return
    names, d = state_digest(tree)
    hi = all_max(group, d)
    lo = torch.bitwise_not(all_max(group, torch.bitwise_not(d)))
    bad = [nm for nm, a, b in zip(names, hi.tolist(), lo.tolist()) if a != b]
    if bad:
        raise RuntimeError(f"{what}: the {group.world_size} ranks differ in "
                           f"{bad}")


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _rank_main(rank, n, port, backend, devices, timeout_s, threads, out_dir,
               fn, args):
    dev = torch.device(devices[rank])
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    torch.set_num_threads(threads)
    dist.init_process_group(
        backend, init_method=f"tcp://127.0.0.1:{port}", rank=rank,
        world_size=n, timeout=datetime.timedelta(seconds=timeout_s))
    try:
        res = fn(DataGroup(rank, n, dev), *args)
        torch.save(tree_map(lambda x: x.detach().cpu(), res),
                   os.path.join(out_dir, f"{rank}.pt"))
    except BaseException:
        # before the group goes down and fails the other ranks' collectives
        with open(os.path.join(out_dir, f"{rank}.err"), "w") as f:
            f.write(traceback.format_exc())
        raise
    finally:
        dist.destroy_process_group()


def spawn(n: int, fn, *args, backend: str = "gloo", devices=None,
          timeout_s: float = 600.0):
    """fn(group, *args) in n new processes (the spawn start method), rank r
    on devices[r] (default: the CPU), the group over
    tcp://127.0.0.1:<a free port> with `timeout_s` on its set-up and on each
    collective. Each rank gets torch.get_num_threads() // n CPU threads.
    fn must be importable by name. Returns every rank's result, tensors on
    the CPU. A rank that raises makes spawn raise a RuntimeError with the
    traceback of the rank that failed first (the others are terminated);
    each rank destroys its process group on exit."""
    devices = ["cpu"] * n if devices is None else [str(d) for d in devices]
    if len(devices) != n:
        raise ValueError(f"spawn: {len(devices)} devices for {n} ranks")
    for d in devices:
        if torch.device(d).type == "cuda" and torch.device(d).index is None:
            raise ValueError(f"spawn: device {d!r} needs its index (cuda:N)")
    threads = max(1, torch.get_num_threads() // n)
    out_dir = tempfile.mkdtemp(prefix="gip_ranks_")
    try:
        torch.multiprocessing.start_processes(
            _rank_main, args=(n, free_port(), backend, devices, timeout_s,
                              threads, out_dir, fn, args),
            nprocs=n, join=True, start_method="spawn")
        return [torch.load(os.path.join(out_dir, f"{r}.pt"),
                           weights_only=False) for r in range(n)]
    except ProcessException as e:
        # the rank that failed first, not one whose collective it broke
        errs = sorted(glob.glob(os.path.join(out_dir, "*.err")),
                      key=os.path.getmtime)
        if not errs:
            raise
        with open(errs[0]) as f:
            first = f.read()
        rank = os.path.basename(errs[0]).split(".")[0]
        raise RuntimeError(f"spawn: rank {rank} of {n} failed first:\n"
                           f"{first}") from e
    finally:
        shutil.rmtree(out_dir, ignore_errors=True)
