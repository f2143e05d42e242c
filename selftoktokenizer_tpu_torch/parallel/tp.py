"""Tensor parallelism of the MMDiT decoder over the mesh's ``tensor`` axis
(counterpart of the reference ``parallel/tp.py``).

The layout is the reference's Megatron rule, carried over to the port's
state-dict names (``tp_dim``):

* column-parallel (the output features split over the ranks): the joint
  blocks' ``attn.qkv``, ``mlp.fc1`` and ``adaLN_modulation.1`` (also the
  final layer's), and the first linear of every timestep embedder
  (``t_embedder.mlp.0``, ``y_embedder.mlp.0``); weight and bias;
* row-parallel (the input features split): ``attn.proj``, ``mlp.fc2`` and
  the embedders' ``mlp.2``; weight only, the bias stays whole;
* everything else whole on every rank, and a leaf whose split axis does not
  divide by the axis size too (the reference's fallback).

The reference leaves the activations to XLA's sharding propagation. The
port has none, so ``apply_tp`` makes the layout work by hand:

* each rank keeps only its shard of a split leaf, as a plain parameter, and
  the linear gets a ``tp`` role (``TPRole``) that ``ops.linear.linear_apply``
  runs: a column product reads the whole activation through ``copy_to_tp``
  (identity forward, all_reduce of the gradient backward), a row product
  sums the ranks' partial outputs through ``reduce_from_tp`` (all_reduce
  forward, identity backward) and then adds the bias. The kernels keep
  receiving plain local tensors;
* ``attn.qkv``'s output is reshaped to [B, L, 3, H, 64]. A contiguous split
  of its rows would give rank 0 all of q and part of k, so its rows are
  taken head-wise: rank r holds heads [r H/tp, (r+1) H/tp) of q, of k and
  of v, in that order (``shard_leaf``; ``gather_leaf`` restores the order).
  The attention kernel then runs on [B, H/tp, L, 64], and ``attn.proj``'s
  input columns, split contiguously, are those heads' features;
* the adaLN output is chunked into 6 (or 2) modulations, each applied to
  the whole hidden state, so its column product gathers its output over the
  ranks (``gather_from_tp``; the backward takes the rank's slice).

The number of heads must divide by the axis size.
"""

from __future__ import annotations

import torch
import torch.distributed as dist
from torch import nn

from selftoktokenizer_tpu_torch.ops.linear import linear

# module-name suffixes of the reference's _COLUMN / _ROW parents in the
# decoder ("qkv", "fc1", "adaLN", "mlp0"; "proj", "fc2", "mlp2")
COLUMN = ("attn.qkv", "mlp.fc1", "adaLN_modulation.1", "t_embedder.mlp.0", "y_embedder.mlp.0")
ROW = ("attn.proj", "mlp.fc2", "t_embedder.mlp.2", "y_embedder.mlp.2")


def role_of(module_name):
    """'column', 'row' or None for a linear of the decoder, by its name."""
    if module_name.endswith(COLUMN):
        return "column"
    if module_name.endswith(ROW):
        return "row"
    return None


def tp_dim(param_name, shape, tensor):
    """The axis of a decoder parameter (torch layout, an ``nn.Linear``
    weight [out, in]) split over ``tensor`` ranks, or None (whole on every
    rank): column weights and biases on their output axis 0, row weights
    on their input axis 1; None where that axis does not divide."""
    module, _, leaf = param_name.rpartition(".")
    kind = role_of(module)
    if kind == "column" and leaf in ("weight", "bias"):
        dim = 0
    elif kind == "row" and leaf == "weight":
        dim = 1
    else:
        return None
    return dim if shape[dim] % tensor == 0 else None


def _headwise(param_name):
    return param_name.rpartition(".")[0].endswith("attn.qkv")


def shard_leaf(param_name, full, rank, tensor, dim):
    """Rank ``rank``'s shard of a whole leaf split on ``dim`` (None: the
    leaf itself). qkv rows go head-wise: [3, tensor, D/tensor, ...] -> this
    rank's [3 * D/tensor, ...]."""
    if dim is None:
        return full
    if _headwise(param_name):
        v = full.reshape(3, tensor, full.shape[0] // (3 * tensor), *full.shape[1:])
        return v[:, rank].reshape(-1, *full.shape[1:])
    return full.chunk(tensor, dim)[rank]


def gather_leaf(param_name, local, group, dim):
    """The whole leaf from every rank's shard (``shard_leaf``'s inverse);
    a collective over ``group``."""
    if dim is None:
        return local
    local = local.contiguous()
    parts = [torch.empty_like(local) for _ in range(dist.get_world_size(group))]
    dist.all_gather(parts, local, group=group)
    if _headwise(param_name):
        parts = [p.reshape(3, -1, *p.shape[1:]) for p in parts]
        full = torch.stack(parts, dim=1)
        return full.reshape(-1, *full.shape[3:])
    return torch.cat(parts, dim=dim)


# ---------------------------------------------------------------------------
# the Megatron regions
# ---------------------------------------------------------------------------

class _CopyToTP(torch.autograd.Function):
    """Identity forward; the gradient summed over the ranks backward."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        g = g.contiguous().clone()
        dist.all_reduce(g, group=ctx.group)
        return g, None


class _ReduceFromTP(torch.autograd.Function):
    """The ranks' partial outputs summed forward; identity backward."""

    @staticmethod
    def forward(ctx, x, group):
        y = x.contiguous().clone()
        dist.all_reduce(y, group=group)
        return y

    @staticmethod
    def backward(ctx, g):
        return g, None


class _GatherFromTP(torch.autograd.Function):
    """The ranks' last-axis slices concatenated forward; this rank's slice
    of the gradient backward."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        x = x.contiguous()
        parts = [torch.empty_like(x) for _ in range(dist.get_world_size(group))]
        dist.all_gather(parts, x, group=group)
        return torch.cat(parts, dim=-1)

    @staticmethod
    def backward(ctx, g):
        n = dist.get_world_size(ctx.group)
        return g.chunk(n, dim=-1)[dist.get_rank(ctx.group)].contiguous(), None


def copy_to_tp(x, group):
    return _CopyToTP.apply(x, group)


def reduce_from_tp(x, group):
    return _ReduceFromTP.apply(x, group)


def gather_from_tp(x, group):
    return _GatherFromTP.apply(x, group)


class TPRole:
    """How a linear holding its tensor-parallel shard is applied
    (``ops.linear.linear_apply`` calls it with the module's weight and
    bias): 'column' (gather: concatenate the ranks' outputs) or 'row'."""

    def __init__(self, kind, group, gather=False):
        self.kind, self.group, self.gather = kind, group, gather

    def __call__(self, x, weight, bias):
        if self.kind == "column":
            y = linear(copy_to_tp(x, self.group), weight, bias)
            return gather_from_tp(y, self.group) if self.gather else y
        y = reduce_from_tp(linear(x, weight), self.group)
        return y if bias is None else y + bias.to(y.dtype)


@torch.no_grad()
def apply_tp(model: nn.Module, group, prefix=""):
    """Split the decoder ``model`` (an ``MMDiT``) over the ranks of
    ``group``, in place: each split leaf is replaced by this rank's shard
    (a new parameter) and its linear gets its ``TPRole``. Returns
    {prefixed parameter name: split axis} of the split leaves."""
    tensor, rank = dist.get_world_size(group), dist.get_rank(group)
    heads = model.cfg.num_heads
    if heads % tensor:
        raise ValueError(f"apply_tp: {heads} heads do not split over {tensor} tensor ranks")
    layout = {}
    for mname, m in model.named_modules():
        kind = role_of(mname)
        if kind is None or not isinstance(m, nn.Linear):
            continue
        dim = tp_dim(f"{mname}.weight", tuple(m.weight.shape), tensor)
        if dim is None:
            continue                  # whole on every rank, as the reference falls back
        for leaf in ("weight", "bias"):
            p = getattr(m, leaf)
            name = f"{mname}.{leaf}"
            d = tp_dim(name, tuple(p.shape), tensor) if p is not None else None
            if d is None:
                continue
            setattr(m, leaf, nn.Parameter(shard_leaf(name, p.detach(), rank, tensor, d).clone(),
                                          requires_grad=p.requires_grad))
            layout[prefix + name] = d
        m.tp = TPRole(kind, group, gather=mname.endswith("adaLN_modulation.1"))
    return layout
