"""The device mesh of data parallelism (counterpart of the reference
``parallel/mesh.py``, without its FSDP layout).

The mesh keeps the reference's axis names (``data``, ``fsdp``, ``tensor``)
over a ``torch.distributed.device_mesh.DeviceMesh``. Only ``data`` may be
wider than one: FSDP and tensor parallelism are not ported (``ROADMAP.md``
§1, "FSDP and TP") and raise.
"""

from __future__ import annotations

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import init_device_mesh

from selftoktokenizer_tpu_torch.parallel.distributed import comm_device, rank_and_world

AXES = ("data", "fsdp", "tensor")


def make_mesh(data=-1, fsdp=1, tensor=1):
    """A ('data', 'fsdp', 'tensor') mesh over the ranks of the initialized
    default group (``distributed.init`` first). data=-1: every rank."""
    if fsdp != 1 or tensor != 1:
        raise NotImplementedError(
            f"make_mesh(fsdp={fsdp}, tensor={tensor}): FSDP and tensor parallelism are "
            "not ported (ROADMAP.md §1, 'FSDP and TP'); only the data axis may be > 1")
    if not dist.is_initialized():
        raise RuntimeError("make_mesh needs an initialized process group "
                           "(parallel.distributed.init)")
    world = dist.get_world_size()
    data = world if data == -1 else data
    if data != world:
        raise ValueError(f"make_mesh: data={data} must equal the world size {world}")
    return init_device_mesh(comm_device().type, (data, 1, 1), mesh_dim_names=AXES)


def psum_metrics(metrics, group=None):
    """The mean of each metric over the ranks of ``group`` (a mesh axis's
    group: ``mesh.get_group('data')``), by all_reduce; a dict of numbers or
    scalar tensors in, a dict of float32 tensors out."""
    _, w = rank_and_world(group)
    keys = sorted(metrics)
    vals = torch.stack([torch.as_tensor(metrics[k], dtype=torch.float32).reshape(())
                        .to(comm_device(group)) for k in keys])
    if dist.is_initialized():
        dist.all_reduce(vals, group=group)
        vals = vals / w
    return dict(zip(keys, vals.unbind(0)))
