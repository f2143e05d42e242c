"""Process group set-up and cross-rank helpers over ``torch.distributed``
(counterpart of the reference ``parallel/distributed.py``).

One process per GPU, as ``torchrun`` starts them. ``init`` forms the group
from the launcher's environment (``RANK``, ``WORLD_SIZE``, ``MASTER_ADDR``,
``MASTER_PORT``, ``LOCAL_RANK``) or from an explicit ``init_method``: NCCL
for CUDA, gloo only when the caller asks for it (the CPU). With no cluster
variable set and no ``init_method`` the process stays single; once any is
set, a group that cannot form raises. It never degrades to one process:
every host would then train the whole dataset and write the same
checkpoints.

The helpers take an optional ``group`` (the default group when None).
Outside an initialized group they act as a world of one; inside one they
always run their collective, a group of one rank included, so a one-rank
run exercises every collective a wider one makes.
"""

from __future__ import annotations

import os

import numpy as np
import torch
import torch.distributed as dist

CLUSTER_VARS = ("RANK", "WORLD_SIZE", "LOCAL_RANK", "MASTER_ADDR", "MASTER_PORT")


def init(backend=None, init_method=None, rank=None, world_size=None, timeout=None):
    """Form the default process group; idempotent. Returns whether a group
    exists afterwards (False: single process, nothing indicated a cluster).

    backend: None means NCCL, which needs CUDA (raises without it); pass
    'gloo' to run the ranks on the CPU. rank / world_size: explicit, else
    read from the environment. timeout: a ``datetime.timedelta`` for the
    group's formation and collectives."""
    if dist.is_initialized():
        return True
    if init_method is None and not any(os.environ.get(v) for v in CLUSTER_VARS):
        return False
    if backend is None:
        if not torch.cuda.is_available():
            raise RuntimeError("distributed.init: NCCL needs a CUDA device; pass "
                               "backend='gloo' to run the ranks on the CPU")
        backend = "nccl"
    if backend == "nccl":
        torch.cuda.set_device(int(os.environ.get("LOCAL_RANK", 0)))
    kw = {} if timeout is None else {"timeout": timeout}
    dist.init_process_group(backend, init_method=init_method,
                            rank=-1 if rank is None else rank,
                            world_size=-1 if world_size is None else world_size, **kw)
    return True


def rank_and_world(group=None):
    """(this process's rank in ``group``, its size); (0, 1) outside a group."""
    if not dist.is_initialized():
        return 0, 1
    return dist.get_rank(group), dist.get_world_size(group)


def comm_device(group=None):
    """Where the group's tensors must lie: the current CUDA device for NCCL,
    the CPU otherwise."""
    if dist.is_initialized() and dist.get_backend(group) == "nccl":
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device("cpu")


def process_slice(n_items, rank=None, world_size=None):
    """This rank's (start, stop) of n_items split evenly in rank order; the
    last rank takes the remainder (which the data-parallel step refuses:
    its global batch must split evenly)."""
    r, w = rank_and_world()
    r = r if rank is None else rank
    w = w if world_size is None else world_size
    per = n_items // w
    return r * per, (r + 1) * per if r < w - 1 else n_items


def local_rows(batch, group=None):
    """This rank's rows of a global batch (``process_slice`` of its first
    axis)."""
    r, w = rank_and_world(group)
    lo, hi = process_slice(batch.shape[0], r, w)
    return batch[lo:hi]


def all_gather_rows(local, group=None):
    """The global batch from every rank's rows, in rank order (the inverse
    of ``local_rows`` when the rows split evenly). Every rank must pass the
    same shape: the shapes are gathered first, and every rank raises
    ``ValueError`` when they differ (an uneven split of the global batch)."""
    if not dist.is_initialized():
        return local
    _, w = rank_and_world(group)
    shape = torch.tensor(local.shape, dtype=torch.int64, device=comm_device(group))
    shapes = [torch.empty_like(shape) for _ in range(w)]
    dist.all_gather(shapes, shape, group=group)
    if any(not torch.equal(s, shape) for s in shapes):
        raise ValueError("all_gather_rows: the ranks hold different shapes "
                         f"{[tuple(s.tolist()) for s in shapes]}; split the global batch evenly")
    local = local.contiguous()
    parts = [torch.empty_like(local) for _ in range(w)]
    dist.all_gather(parts, local, group=group)
    return torch.cat(parts, dim=0)


def broadcast_(tensors, src=0, group=None):
    """Overwrite each tensor with ``group_rank`` ``src``'s, in place (bool
    tensors travel as uint8)."""
    if not dist.is_initialized():
        return tensors
    s = src if group is None else dist.get_global_rank(group, src)
    for t in tensors:
        if t.dtype == torch.bool:
            u = t.to(torch.uint8)
            dist.broadcast(u, s, group=group)
            t.copy_(u.bool())
        else:
            dist.broadcast(t, s, group=group)
    return tensors


def allgather_f64(arr, group=None):
    """Every rank's float64 array, bit for bit (sent as bytes). Returns a
    numpy array [world, *arr.shape]. Merges the FID moment accumulators of
    a multi-rank evaluation."""
    arr = np.ascontiguousarray(np.asarray(arr, np.float64))
    if not dist.is_initialized():
        return arr[None].copy()
    _, w = rank_and_world(group)
    b = torch.from_numpy(arr.reshape(-1).view(np.uint8).copy()).to(comm_device(group))
    parts = [torch.empty_like(b) for _ in range(w)]
    dist.all_gather(parts, b, group=group)
    out = torch.stack(parts).cpu().numpy()
    return out.view(np.float64).reshape((w,) + arr.shape)
