"""The collective layer of the multi-device solvers: ``ShardMesh``.

JAX runs every sharded solver as one ``shard_map`` region over a 1D mesh
axis "shard" and communicates through three primitives: ``ppermute`` of
halo strips to the neighbours, ``psum`` and ``all_gather``. Here one
process runs one shard (rank r of N), and a ``ShardMesh`` gives the three
primitives over a ``torch.distributed`` process group:

- ``halo(x, H)``: the left neighbour's last H rows and the right
  neighbour's first H rows, zeros at the ends (one ``batch_isend_irecv``);
- ``psum(t)``: ``all_reduce`` (sum);
- ``all_gather(t)``: the shards' tensors concatenated along dim 0.

A world of one without a process group communicates nothing: ``halo``
gives zeros, ``psum`` and ``all_gather`` return their input. A world of
one with a group (``init_world(world_size=1)``) still runs every psum and
all_gather as a collective: an NCCL launch on the card.

A CUDA world uses NCCL, a CPU world gloo, and only when the caller asks for
``device="cpu"``: no path moves a tensor to another device. This is the
only module of the package that calls ``torch.distributed``.
"""

from __future__ import annotations

import datetime
import os

import torch
import torch.distributed as dist

__all__ = ["ShardMesh", "close_world", "init_world", "make_device_mesh"]

_world_device = None  # this rank's device, set by init_world
# a rank waiting this long in a collective raises instead of hanging
_TIMEOUT = datetime.timedelta(seconds=300)


class ShardMesh:
    """One rank's view of a 1D mesh of ``size`` shards: its ``rank``, its
    ``device`` and the process ``group`` (None: a world of one)."""

    def __init__(self, group=None, device="cuda"):
        self.group = group
        self.device = torch.device(device)
        self.rank = 0 if group is None else dist.get_rank(group)
        self.size = 1 if group is None else dist.get_world_size(group)

    def __repr__(self):
        return f"ShardMesh(rank={self.rank}, size={self.size}, device={self.device})"

    def halo(self, x, H: int):
        """(left, right): rows x[-H:] of the shard before this one and x[:H]
        of the shard after it, as JAX's two ``ppermute`` give them; zeros
        where there is no neighbour. x: (rows, ...) with rows >= H."""
        left = x.new_zeros((H,) + tuple(x.shape[1:]))
        right = x.new_zeros((H,) + tuple(x.shape[1:]))
        if self.size > 1:
            r, ops = self.rank, []
            if r > 0:
                ops += [dist.P2POp(dist.isend, x[:H].contiguous(), r - 1, self.group),
                        dist.P2POp(dist.irecv, left, r - 1, self.group)]
            if r < self.size - 1:
                ops += [dist.P2POp(dist.isend, x[-H:].contiguous(), r + 1, self.group),
                        dist.P2POp(dist.irecv, right, r + 1, self.group)]
            for work in dist.batch_isend_irecv(ops):
                work.wait()
        return left, right

    def halo_extend(self, x, H: int):
        """The (rows + 2H, ...) halo-extended block [left; x; right]."""
        left, right = self.halo(x, H)
        return torch.cat([left, x, right])

    def psum(self, t):
        """The sum of t over the shards. A group reduces t in place (pass a
        fresh tensor) and returns it."""
        if self.group is not None:
            dist.all_reduce(t, group=self.group)
        return t

    def all_gather(self, t):
        """The shards' t (equal shapes) concatenated along dim 0, on every
        shard."""
        if self.group is None:
            return t
        parts = [torch.empty_like(t) for _ in range(self.size)]
        dist.all_gather(parts, t.contiguous(), group=self.group)
        return torch.cat(parts)


def init_world(device="cuda", rank: int | None = None, world_size: int | None = None,
               store_file: str | None = None) -> ShardMesh:
    """Initialise the default process group and return its ShardMesh.

    NCCL for a CUDA device, gloo for ``device="cpu"``. ``rank`` and
    ``world_size`` None: torchrun's environment (RANK, WORLD_SIZE,
    LOCAL_RANK picks the card). ``store_file``: a ``FileStore`` path the
    ranks share; without it a world of one uses a ``HashStore``."""
    global _world_device
    dev = torch.device(device)
    kw = dict(timeout=_TIMEOUT)
    if rank is None:
        rank, world_size = int(os.environ["RANK"]), int(os.environ["WORLD_SIZE"])
        if dev.type == "cuda" and dev.index is None:
            dev = torch.device("cuda", int(os.environ.get("LOCAL_RANK", 0)))
        kw["init_method"] = "env://"
    elif store_file is not None:
        kw["store"] = dist.FileStore(store_file, world_size)
    elif world_size == 1:
        kw["store"] = dist.HashStore()
    else:
        raise ValueError("a world of more than one rank needs store_file or torchrun's environment")
    if dev.type == "cuda":
        if dev.index is None:
            dev = torch.device("cuda", 0)
        torch.cuda.set_device(dev)
        kw["device_id"] = dev
        backend = "nccl"
    elif dev.type == "cpu":
        backend = "gloo"
    else:
        raise ValueError(f"unsupported device {dev}")
    dist.init_process_group(backend, rank=rank, world_size=world_size, **kw)
    _world_device = dev
    return ShardMesh(dist.group.WORLD, dev)


def close_world():
    """Destroy the default process group, if there is one."""
    global _world_device
    if dist.is_initialized():
        dist.destroy_process_group()
    _world_device = None


def make_device_mesh(n_devices: int | None = None, device=None) -> ShardMesh:
    """The 1D mesh of ``n_devices`` shards (JAX ``sharded.py:34``).

    In an initialised world: the whole world for None or its size, this
    rank alone (a world of one) for 1. Without one: a world of one on
    ``device`` (default ``"cuda"``); more shards raise, since a shard is a
    process (``init_world``, or torchrun)."""
    if dist.is_initialized():
        world = dist.get_world_size()
        if device is None:
            device = _world_device or (
                torch.device("cuda", torch.cuda.current_device())
                if dist.get_backend() == "nccl" else torch.device("cpu"))
        if n_devices in (None, world):
            return ShardMesh(dist.group.WORLD, device)
        if n_devices == 1:
            return ShardMesh(None, device)
        raise ValueError(f"{n_devices} shards asked of a world of {world} ranks")
    if n_devices not in (None, 1):
        raise ValueError(f"{n_devices} shards need {n_devices} ranks: init_world (or torchrun) "
                         "in each of them first")
    return ShardMesh(None, "cuda" if device is None else device)
