"""The device mesh and the sharded layout of the tokenizer (counterpart of
the reference ``parallel/mesh.py``, with ``parallel/tp.py``'s combined
layout).

The mesh keeps the reference's axis names (``data``, ``fsdp``, ``tensor``)
over a ``torch.distributed.device_mesh.DeviceMesh``. The layout is the
reference's, as a function of the axis sizes and the parameter shapes
(``fsdp_dim``, ``tp_fsdp_dims``, ``tokenizer_layout``), in the torch layout:
an ``nn.Linear`` weight is [out, in] where the reference's ``w`` is
[in, out], so a tie between two largest axes goes to the one that comes
first in the reference's layout.

``shard_tokenizer`` applies it: tensor parallelism on the decoder when the
layout asks for it (``parallel.tp.apply_tp``), then FSDP2
(``torch.distributed.fsdp.fully_shard``) over the ``data`` x ``fsdp``
sub-mesh, which shards on ``fsdp`` and replicates on ``data``: one group
for each joint block of the decoder (called as a module by
``models.mmdit._trunk``), one for the rest of the tokenizer, gathered
around ``ImageTokenizer.run``. FSDP2 shards every parameter, so a leaf the
reference keeps whole (below 2^14 elements, or with no axis that divides)
is sharded on its largest axis that divides, else on axis 0 with padding
(``fsdp2_dim``).
"""

from __future__ import annotations

import dataclasses
import math
from typing import Optional

import torch
import torch.distributed as dist
from torch import nn
from torch.distributed.device_mesh import DeviceMesh, init_device_mesh

from selftoktokenizer_tpu_torch.parallel import tp as tp_mod
from selftoktokenizer_tpu_torch.parallel.distributed import (
    comm_device, local_rows, rank_and_world)

AXES = ("data", "fsdp", "tensor")

# the reference's fsdp_param_spec floor: smaller leaves stay whole
FSDP_MIN_NUMEL = 2 ** 14


def make_mesh(data=-1, fsdp=1, tensor=1):
    """A ('data', 'fsdp', 'tensor') mesh over the ranks of the initialized
    default group (``distributed.init`` first). data=-1: the ranks that
    fsdp x tensor leave. A shape whose product is not the world size (1
    without a group) raises ``ValueError``."""
    world = dist.get_world_size() if dist.is_initialized() else 1
    if data == -1:
        if world % (fsdp * tensor):
            raise ValueError(f"make_mesh: fsdp={fsdp} x tensor={tensor} does not divide the "
                             f"world size {world}")
        data = world // (fsdp * tensor)
    if data * fsdp * tensor != world:
        raise ValueError(f"make_mesh: data={data} x fsdp={fsdp} x tensor={tensor} is not the "
                         f"world size {world}")
    if not dist.is_initialized():
        raise RuntimeError("make_mesh needs an initialized process group "
                           "(parallel.distributed.init)")
    return init_device_mesh(comm_device().type, (data, fsdp, tensor), mesh_dim_names=AXES)


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


# ---------------------------------------------------------------------------
# the layout: functions of the axis sizes and the shapes
# ---------------------------------------------------------------------------

def _largest(shape, dims, transposed):
    """The largest of ``dims``; ties go to the first in the reference's
    layout, which reverses a linear weight's two axes (``transposed``)."""
    dims = list(dims)
    return max(dims[::-1] if transposed else dims, key=lambda d: shape[d])


def fsdp_dim(shape, fsdp, transposed=False):
    """The reference's FSDP rule (``fsdp_param_spec`` and
    ``fsdp_shardings``): a leaf of at least 2^14 elements is sharded over
    ``fsdp`` on its largest axis when that axis divides; else None (whole)."""
    if len(shape) == 0 or math.prod(shape) < FSDP_MIN_NUMEL:
        return None
    d = _largest(shape, range(len(shape)), transposed)
    return d if shape[d] % fsdp == 0 else None


def tp_fsdp_dims(shape, tensor, fsdp, t_dim, transposed=False):
    """The reference's combined rule (``tp_fsdp_shardings``) for a leaf whose
    tensor-parallel axis is ``t_dim`` (None: not split): (t_dim, fsdp axis):
    a split leaf of at least 2^14 elements takes ``fsdp`` on its largest
    other axis when that divides; any other leaf follows ``fsdp_dim``."""
    if t_dim is None:
        return None, fsdp_dim(shape, fsdp, transposed)
    free = [d for d in range(len(shape)) if d != t_dim]
    if math.prod(shape) >= FSDP_MIN_NUMEL and free:
        d = _largest(shape, free, transposed)
        if shape[d] % fsdp == 0:
            return t_dim, d
    return t_dim, None


def fsdp2_dim(shape, fsdp, rule_dim, transposed=False):
    """The axis FSDP2 shards a leaf on (its local shape under tensor
    parallelism): the rule's; for a leaf the rule keeps whole, its largest
    axis that divides by ``fsdp``, else axis 0, which FSDP2 pads."""
    if rule_dim is not None:
        return rule_dim
    dims = [d for d in range(len(shape)) if shape[d] % fsdp == 0]
    return _largest(shape, dims, transposed) if dims else 0


def linear_weights(module: nn.Module):
    """Names of the ``nn.Linear`` weights of ``module`` (the leaves whose
    layout is the reference's transposed)."""
    return {f"{n}.weight" if n else "weight" for n, m in module.named_modules()
            if isinstance(m, nn.Linear)}


def tokenizer_layout(tok: nn.Module, fsdp, tensor, tp):
    """{parameter name: (tensor axis, fsdp axis)} of an ``ImageTokenizer``
    under the reference's rule, None where the leaf is whole on that axis.
    tp: split the decoder (``model.*``) over ``tensor`` (the reference's
    ``tp_fsdp_shardings``; everything else follows ``fsdp_dim``, as its
    multi-chip dry run lays out the tokenizer)."""
    lin = linear_weights(tok)
    out = {}
    for name, p in tok.named_parameters():
        shape = tuple(p.shape)
        t_dim = None
        if tp and name.startswith("model."):
            t_dim = tp_mod.tp_dim(name[len("model."):], shape, tensor)
        out[name] = tp_fsdp_dims(shape, tensor, fsdp, t_dim, name in lin)
    return out


# ---------------------------------------------------------------------------
# applying it
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class Sharding:
    """A tokenizer sharded over ``mesh`` (``shard_tokenizer``).

    dp_group: the ranks at this rank's ``tensor`` coordinate (data x fsdp),
    which hold different rows of a batch; tp_group: the ``tensor`` axis,
    whose ranks share their rows (None without tensor parallelism);
    tp_layout: {parameter name: split axis} of the tensor-parallel leaves;
    tp_split: ids of those parameters (as FSDP2 registered them)."""
    mesh: DeviceMesh
    dp_group: object
    tp_group: Optional[object]
    tp_layout: dict
    tp_split: set

    def local_rows(self, batch):
        """This rank's rows of a global batch: its share at its data x fsdp
        position, the same on every tensor rank."""
        return local_rows(batch, self.dp_group)

    def full(self, name, t):
        """The whole leaf ``name`` from its shards (a parameter, its
        gradient or an optimizer moment); a collective over the mesh."""
        from torch.distributed.tensor import DTensor

        if isinstance(t, DTensor):
            t = t.full_tensor()
        d = self.tp_layout.get(name)
        return t if d is None else tp_mod.gather_leaf(name, t, self.tp_group, d)

    def _tp_shard(self, name, full):
        """This rank's tensor-parallel shard of the whole leaf ``name``."""
        d = self.tp_layout.get(name)
        if d is None:
            return full
        return tp_mod.shard_leaf(name, full, dist.get_rank(self.tp_group),
                                 dist.get_world_size(self.tp_group), d)

    @torch.no_grad()
    def set_full_(self, name, t, full):
        """Write the whole leaf ``full`` into ``t``'s shard, in place."""
        from torch.distributed.tensor import DTensor

        full = self._tp_shard(name, full)
        if isinstance(t, DTensor):
            t.to_local().copy_(_local_chunk(full, t))
        else:
            t.copy_(full)

    def to_sharded(self, name, like, full):
        """A tensor laid out as the parameter ``like`` (a DTensor under
        FSDP2) holding the whole leaf ``full``: an optimizer moment being
        restored."""
        from torch.distributed.tensor import DTensor

        full = self._tp_shard(name, full).to(device=like.device, dtype=like.dtype)
        if not isinstance(like, DTensor):
            return full.clone()
        return DTensor.from_local(_local_chunk(full, like).clone(), like.device_mesh,
                                  like.placements, run_check=False, shape=full.shape,
                                  stride=full.stride())

    @torch.no_grad()
    def grad_norm(self, params):
        """The global norm of the whole gradients of ``params``: the squares
        summed over the shards of every sharded axis, each replicated copy
        counted once."""
        from torch.distributed.tensor import DTensor

        dev = comm_device(self.dp_group)
        sq = torch.zeros(2, dtype=torch.float32, device=dev)    # [tp-split, whole on tensor]
        parts = ([], [])
        for p in params:
            g = p.grad.to_local() if isinstance(p.grad, DTensor) else p.grad
            parts[0 if id(p) in self.tp_split else 1].append(torch.sum(g.float() ** 2))
        for i, ps in enumerate(parts):
            if ps:
                sq[i] = torch.stack(ps).sum().to(dev)
        # FSDP shards: the fsdp axis; the data axis holds replicas
        dist.all_reduce(sq, group=self.mesh.get_group("fsdp"))
        if self.tp_group is not None:
            dist.all_reduce(sq[0:1], group=self.tp_group)
        return torch.sqrt(sq.sum())


def _local_chunk(full, dt):
    """This rank's chunk of ``full`` under DTensor ``dt``'s placements
    (``torch.chunk`` per sharded mesh axis, as FSDP2 and DTensor split; an
    empty slice past the last chunk)."""
    coord = dt.device_mesh.get_coordinate()
    t = full
    for i, pl in enumerate(dt.placements):
        if pl.is_shard():
            chunks = torch.chunk(t, dt.device_mesh.size(i), dim=pl.dim)
            t = chunks[coord[i]] if coord[i] < len(chunks) else t.narrow(pl.dim, 0, 0)
    return t


def _dp_group(mesh: DeviceMesh):
    """The process group of the data x fsdp ranks at this rank's tensor
    coordinate (every rank makes every such group, in the same order)."""
    ranks = mesh.mesh
    mine = mesh.get_coordinate()[2]
    group = None
    for t in range(ranks.shape[2]):
        g = dist.new_group(ranks[:, :, t].reshape(-1).tolist())
        if t == mine:
            group = g
    return group


def shard_tokenizer(tok: nn.Module, mesh: DeviceMesh, tp=None) -> Sharding:
    """Shard an ``ImageTokenizer`` over ``mesh``, in place: the decoder split
    over ``tensor`` (tp None: when that axis is wider than 1; True also
    applies the tensor-parallel wrappers on an axis of one rank), then FSDP2
    on the data x fsdp sub-mesh with the layout of ``tokenizer_layout``.
    Build the optimizer and any EMA copy afterwards, from the sharded
    parameters."""
    from torch.distributed.fsdp import fully_shard, register_fsdp_forward_method
    from torch.distributed.tensor import Shard

    tensor, fsdp = mesh.size(2), mesh.size(1)
    tp = tensor > 1 if tp is None else tp
    if tensor > 1 and not tp:
        raise ValueError("shard_tokenizer: a tensor axis wider than 1 needs tp")
    layout = tokenizer_layout(tok, fsdp, tensor, tp)
    lin = linear_weights(tok)
    tp_group = mesh.get_group("tensor") if tp else None
    tp_layout = tp_mod.apply_tp(tok.model, tp_group, prefix="model.") if tp else {}
    if {n: layout[n][0] for n in tp_layout} != tp_layout:
        raise AssertionError("apply_tp split other leaves than the layout")

    dims = {}
    for name, p in tok.named_parameters():
        t_dim, f_dim = layout[name]
        dims[id(p)] = fsdp2_dim(tuple(p.shape), fsdp, f_dim, name in lin)

    def placement(p):
        return Shard(dims[id(p)])

    dp_mesh = mesh["data", "fsdp"]
    for block in tok.model.joint_blocks:
        fully_shard(block, mesh=dp_mesh, shard_placement_fn=placement)
    fully_shard(tok, mesh=dp_mesh, shard_placement_fn=placement, reshard_after_forward=True)
    register_fsdp_forward_method(tok, "run")
    split = {id(p) for n, p in tok.named_parameters() if n in tp_layout}
    return Sharding(mesh=mesh, dp_group=_dp_group(mesh), tp_group=tp_group,
                    tp_layout=tp_layout, tp_split=split)
