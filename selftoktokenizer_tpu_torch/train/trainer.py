"""Training steps for the tokenizer and for the one-step renderer
(counterpart of the reference ``train/trainer.py``).

* per-group learning rates: ``dit_lr`` for the decoder (``model.*``),
  ``token_lr`` for everything else, each with its schedule (warmup, then
  constant, cosine or linear decay);
* ``torch.optim.AdamW`` over both groups, with gradients clipped by one
  global norm over all parameters before the step;
* the quantizer's EMA state (``models.vq.VQState``) is part of the train
  state; after each optimizer step the EMA codebook is written into the
  quantizer's ``embed``;
* an optional EMA copy of the parameters (``ema_decay > 0``).

A step mutates the state it is given (modules, optimizer) and returns it
with the step's log dict. Randomness comes from the ``torch.Generator``
passed as ``rng``, or from explicit draws (see ``models.tokenizer``).

A global batch larger than one step holds: ``train_step_accum`` runs the
VQ statistics once over the global batch without gradient (phase A), then
accumulates the gradients over microbatches against the frozen global
quantities (phase B, ``models.vq.vq_microbatch_surrogate``), so its step
equals ``train_step`` on the whole batch while the activations stay at one
microbatch. ``dp_train_step`` is the same step with the microbatches placed
on the ranks of a ``torch.distributed`` group.

Sharded training: ``make_train_state(..., mesh=)`` shards the tokenizer
over a ('data', 'fsdp', 'tensor') mesh (``parallel.mesh.shard_tokenizer``:
FSDP2 over data x fsdp, the decoder split over tensor), and
``dp_train_step`` then places the rows on the data x fsdp ranks, the
tensor ranks of a group sharing theirs. FSDP2 averages the gradients over
those ranks; the clip takes the norm of the whole gradients
(``Sharding.grad_norm``); the codebook is written into every shard; a
checkpoint holds the whole, unsharded state, and restores into a state
sharded or not.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Optional

import torch
import torch.distributed as dist
from torch.distributed.tensor import DTensor

from selftoktokenizer_tpu_torch.core.checkpoint import (
    ema_update, restore_checkpoint, save_checkpoint)
from selftoktokenizer_tpu_torch.models import vq as vq_mod
from selftoktokenizer_tpu_torch.models.encoder import QformerEncoder
from selftoktokenizer_tpu_torch.models.mmdit import MMDiT
from selftoktokenizer_tpu_torch.models.tokenizer import (
    ImageTokenizer, TokenizerConfig, loss_draws, pre_vq_outs, renderer_train_loss,
    tokenizer_loss)
from selftoktokenizer_tpu_torch.parallel import distributed as pdist


@dataclasses.dataclass
class TrainConfig:
    dit_lr: float = 1e-5
    token_lr: float = 5e-5
    warmup_steps: int = 0
    max_steps: int = 100000
    grad_norm: float = 0.0          # 0 = no clipping
    weight_decay: float = 0.0
    ema_decay: float = 0.0          # 0 = no EMA copy
    b1: float = 0.9
    b2: float = 0.999
    # 'constant' (warmup, then flat), 'cosine' or 'linear': the decays run
    # from the post-warmup peak to end_lr_ratio * base_lr at max_steps
    schedule: str = "constant"
    end_lr_ratio: float = 0.1


def lr_at(base_lr, tc: TrainConfig, step):
    """The learning rate of the update made at ``step`` (0 for the first):
    a linear warmup from 0, then the schedule."""
    warmup = max(tc.warmup_steps, 0)
    if warmup > 0 and step < warmup:
        return base_lr * step / warmup
    if tc.schedule == "constant":
        return base_lr
    n, span = step - warmup, max(tc.max_steps - warmup, 1)
    frac = min(n, span) / span
    if tc.schedule == "cosine":
        alpha = tc.end_lr_ratio
        return base_lr * ((1 - alpha) * 0.5 * (1 + math.cos(math.pi * frac)) + alpha)
    if tc.schedule == "linear":
        floor = base_lr * tc.end_lr_ratio
        return (base_lr - floor) * (1 - frac) + floor
    raise ValueError(f"unknown lr schedule {tc.schedule!r}")


def _trainable(module):
    return [(n, p) for n, p in module.named_parameters() if p.requires_grad]


def make_optimizer(module, tc: TrainConfig, groups=True):
    """AdamW over the trainable parameters: with ``groups``, ``model.*`` at
    dit_lr and the rest at token_lr; else one group at dit_lr."""
    named = _trainable(module)
    if groups:
        spec = [("dit", tc.dit_lr, [p for n, p in named if n.startswith("model.")]),
                ("token", tc.token_lr, [p for n, p in named if not n.startswith("model.")])]
    else:
        spec = [("dit", tc.dit_lr, [p for _, p in named])]
    return torch.optim.AdamW(
        [{"params": ps, "lr": lr, "base_lr": lr, "name": name} for name, lr, ps in spec if ps],
        betas=(tc.b1, tc.b2), eps=1e-8, weight_decay=tc.weight_decay)


def global_norm(tensors):
    """sqrt of the sum of squares over every tensor, in fp32."""
    return torch.linalg.vector_norm(
        torch.stack([torch.linalg.vector_norm(t.float()) for t in tensors]))


def _local(t):
    """A tensor's local storage: a DTensor's shard, else the tensor."""
    return t.to_local() if isinstance(t, DTensor) else t


@torch.no_grad()
def clip_by_global_norm_(grads, max_norm, norm=None):
    """Scale the gradients in place by max/norm where norm >= max (0: no
    clipping), norm being one global norm over all of them (given, for
    gradients that are shards: ``Sharding.grad_norm``). Returns the norm
    before clipping."""
    if norm is None:
        norm = global_norm(grads)
    if max_norm > 0 and float(norm) >= max_norm:
        for g in grads:
            g = _local(g)
            g.div_(norm.to(g.dtype)).mul_(max_norm)
    return norm


@torch.no_grad()
def apply_update(opt, params, tc: TrainConfig, step, sharding=None):
    """One optimizer step from the gradients in ``.grad``: clip by one
    global norm over all ``params`` (their whole gradients under
    ``sharding``), set each group's learning rate for ``step``, step.
    Returns the norm before clipping."""
    norm = None if sharding is None else sharding.grad_norm(params)
    norm = clip_by_global_norm_([p.grad for p in params], tc.grad_norm, norm)
    for group in opt.param_groups:
        group["lr"] = lr_at(group["base_lr"], tc, step)
    opt.step()
    return norm


def backward_into_grads(module, loss):
    """Gradients of loss into ``.grad`` of the trainable parameters; a
    parameter the loss does not reach gets zeros, as a gradient tree
    would, so weight decay treats every parameter alike. Returns those
    parameters."""
    params = [p for _, p in _trainable(module)]
    for p in params:
        p.grad = None
    loss.backward()
    return _fill_zeros(params)


def _fill_zeros(params):
    for p in params:
        if p.grad is None:
            p.grad = torch.zeros_like(p)
    return params


# ---------------------------------------------------------------------------
# tokenizer
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class TokenizerTrainState:
    model: ImageTokenizer
    opt: torch.optim.Optimizer
    vq_state: vq_mod.VQState
    ema_params: Optional[dict]      # name -> tensor
    step: int = 0
    sharding: Optional[object] = None   # parallel.mesh.Sharding of a sharded model

    def release(self):
        """Drop the references to the modules, the optimizer and the
        states, so their device memory can be given back."""
        self.model = self.opt = self.vq_state = self.ema_params = self.sharding = None


def _ema_copy(module):
    return {n: p.detach().clone() for n, p in module.named_parameters()}


def make_train_state(tok: ImageTokenizer, tcfg: TokenizerConfig, tc: TrainConfig,
                     vq_state=None, mesh=None, tp=None):
    """A fresh train state over ``tok`` (trained in place). vq_state: the
    quantizer's EMA state to start from (a checkpoint's), else a fresh one.
    mesh: a ``parallel.mesh.make_mesh`` mesh to shard ``tok`` over
    (``shard_tokenizer``; tp as there) before the optimizer and the EMA
    copy are built from its shards; the state then trains through
    ``dp_train_step``."""
    if vq_state is None:
        vq_state = vq_mod.vq_state_init(tok.encoder.quantizer, tcfg.k)
    dev = tok.encoder.quantizer.embed.device
    sharding = None
    if mesh is not None:
        from selftoktokenizer_tpu_torch.parallel.mesh import shard_tokenizer
        sharding = shard_tokenizer(tok, mesh, tp)
    return TokenizerTrainState(
        model=tok, opt=make_optimizer(tok, tc), vq_state=vq_state.to(dev),
        ema_params=_ema_copy(tok) if tc.ema_decay > 0 else None, sharding=sharding)


def _unsharded(state: TokenizerTrainState, what):
    if state.sharding is not None:
        raise ValueError(f"{what} takes an unsharded state; a sharded one trains through "
                         "dp_train_step")


def tokenizer_grads(state: TokenizerTrainState, tcfg: TokenizerConfig, batch, rng=None,
                    **draws):
    """The step's forward and backward without the update: gradients into
    ``.grad``. Returns (loss, aux, params) with aux as ``tokenizer_loss``
    gives it. draws: explicit t, noise, drop_ids, gumbel_noise,
    kmeans_idx, react_uniforms, warm_ids."""
    _unsharded(state, "tokenizer_grads")
    state.model.train()
    loss, aux = tokenizer_loss(state.model, tcfg, batch, rng=rng, vq_state=state.vq_state,
                               **draws)
    return loss, aux, backward_into_grads(state.model, loss)


def train_step(state: TokenizerTrainState, tcfg: TokenizerConfig, tc: TrainConfig, batch,
               rng=None, **draws):
    """One optimizer step over the batch (NHWC latents [B,h,w,C]). Returns
    (state, logs): the loss's log dict, the gradients' global norm before
    clipping (``grad_norm``) and the step's token ids (``ids``). The
    gradients stay in ``.grad`` until the next step."""
    _, aux, params = tokenizer_grads(state, tcfg, batch, rng=rng, **draws)
    logs = dict(aux["log_dict"])
    logs["ids"] = aux["ids"]
    return _finish_step(state, tc, params, aux["vq_state"], logs)


CODEBOOK = "encoder.quantizer._codebook.embed"


def _finish_step(state: TokenizerTrainState, tc: TrainConfig, params, vq_state, logs):
    """The update from the gradients in ``.grad``: the optimizer step (one
    global clip), the new VQ state with its codebook written into the
    quantizer (the encode path reads it there; each shard of a sharded
    one), the EMA copy."""
    logs["grad_norm"] = apply_update(state.opt, params, tc, state.step, state.sharding)
    state.vq_state = vq_state
    embed = state.model.encoder.quantizer._codebook.embed
    with torch.no_grad():
        if state.sharding is None:
            embed[0].copy_(vq_state.embed)
        else:
            state.sharding.set_full_(CODEBOOK, embed, vq_state.embed[None])
    if state.ema_params is not None:
        ema_update(state.ema_params, dict(state.model.named_parameters()), tc.ema_decay)
    state.step += 1
    return state, logs


def _phase_a(state: TokenizerTrainState, tcfg: TokenizerConfig, outs, rng, vq_draws):
    """The quantizer's step on the global batch's pre-VQ outputs, without
    gradient: (ids, phase-A loss, new VQ state, VQ logs, extras)."""
    with torch.no_grad():
        _, ids, quan_loss, vq_state, vq_logs, extras = state.model.run(
            lambda tok: vq_mod.vq_train_apply(
                tok.encoder.quantizer, state.vq_state, outs, tcfg.quantizer, rng=rng,
                return_extras=True, **vq_draws))
    return ids, quan_loss, vq_state, vq_logs, extras


def _surrogate_backward(tok, tcfg: TokenizerConfig, batch, rows, ids, extras, t, noise, drop):
    """Phase B on the rows ``rows`` of the global batch: the loss against
    the frozen global quantities, backward into ``.grad`` (accumulating).
    Returns the rows' dm_mse."""
    inj = {"ids": ids[rows], "embed_used": extras["embed_used"], "g_ap": extras["g_ap"]}
    loss, aux = tok.run(tokenizer_loss, tcfg, batch, t=t[rows], noise=noise[rows],
                        drop_ids=None if drop is None else drop[rows], vq_injected=inj)
    loss.backward()
    return aux["log_dict"]["dm_mse"]


def _accum_logs(dm_mse, quan_loss, vq_logs, ids):
    return {"loss": dm_mse + quan_loss.detach(), "dm_mse": dm_mse,
            **{f"vq_{k}": v for k, v in vq_logs.items()}, "ids": ids}


def accum_grads(state: TokenizerTrainState, tcfg: TokenizerConfig, batch, n_micro, group=None,
                rng=None, **draws):
    """The accumulated step's two phases without the update: the averaged
    gradients of the global batch into ``.grad``. Returns (logs, new VQ
    state, params).

    batch: this process's rows [B_l,h,w,C], B_l a multiple of n_micro. With
    ``group`` None it is the whole global batch and nothing is communicated;
    with a ``torch.distributed`` group it is this rank's rows, the same
    count on every rank, in rank order of the global batch (B_g = B_l *
    world): the pre-VQ outputs are gathered, rank 0's phase A is broadcast
    (the GPU's scatter-adds are not bit-deterministic, and the ranks'
    codebooks would otherwise drift apart), and the gradients are averaged
    by all_reduce. A sharded state (``state.sharding``) takes its data x
    fsdp group as ``group``, global rank 0's phase A for every rank, and
    FSDP2's averaged gradients. draws: as ``tokenizer_grads``'s, for the
    global batch (t, noise, drop_ids; kmeans_idx, react_uniforms,
    gumbel_noise) and the same
    on every rank, the missing ones drawn from rng (seeded alike on every
    rank) as ``tokenizer_loss`` draws them, so a generator seeded alike
    gives ``train_step`` the same draws; microbatch i of rank r takes global
    rows r*B_l + [i*B_m, (i+1)*B_m)."""
    B_l = batch.shape[0]
    if n_micro < 1 or B_l % n_micro:
        raise ValueError(f"accum_grads: batch {B_l} is not a multiple of n_micro={n_micro}")
    sharding = state.sharding
    if sharding is not None:
        group = sharding.dp_group
    r, w = (0, 1) if group is None else pdist.rank_and_world(group)
    tok = state.model
    tok.train()
    t, noise, drop = loss_draws(tcfg, (B_l * w,) + tuple(batch.shape[1:]), batch.device, rng,
                                draws.pop("t", None), draws.pop("noise", None),
                                draws.pop("drop_ids", None), batch.dtype)
    with torch.no_grad():
        outs, _ = tok.run(lambda m: pre_vq_outs(m.encoder, tcfg, batch))
    if group is not None:
        outs = pdist.all_gather_rows(outs, group)
    ids, quan_loss, vq_state, vq_logs, extras = _phase_a(state, tcfg, outs, rng, draws)
    del outs
    if group is not None:
        # embed_used may share memory with the input state's codebook: copy
        # it before the broadcast writes into it
        extras = {"embed_used": extras["embed_used"].clone(), "g_ap": extras["g_ap"]}
        keys = sorted(vq_logs)
        scalars = torch.stack([quan_loss.float()] + [vq_logs[k].float() for k in keys])
        pdist.broadcast_([ids, extras["embed_used"], extras["g_ap"], scalars]
                         + list(vq_state.asdict().values()),
                         group=None if sharding is not None else group)
        quan_loss = scalars[0]
        vq_logs = {k: v.to(vq_logs[k].dtype) for k, v in zip(keys, scalars[1:].unbind(0))}

    params = [p for _, p in _trainable(tok)]
    for p in params:
        p.grad = None
    B_m = B_l // n_micro
    dm = []
    for i in range(n_micro):
        lo = r * B_l + i * B_m
        dm.append(_surrogate_backward(tok, tcfg, batch[i * B_m:(i + 1) * B_m],
                                      slice(lo, lo + B_m), ids, extras, t, noise, drop))
    dm = torch.stack(dm).detach().mean()
    _fill_zeros(params)
    if group is not None and sharding is None:
        all_reduce_grads_(params, group, n_micro * w)
    else:
        # one device, or FSDP2's gradients, each microbatch's already
        # averaged over the ranks
        with torch.no_grad():
            for p in params:
                p.grad.div_(n_micro)
    if group is not None:
        dm = dm.float().reshape(1).to(pdist.comm_device(group))
        dist.all_reduce(dm, group=group)
        dm = (dm[0] / w).to(quan_loss.device)
    return _accum_logs(dm, quan_loss, vq_logs, ids), vq_state, params


def train_step_accum(state: TokenizerTrainState, tcfg: TokenizerConfig, tc: TrainConfig, batch,
                     n_micro, rng=None, **draws):
    """One optimizer step over a global batch of n_micro microbatches, on
    one device: equal to ``train_step`` on the whole batch (the VQ
    statistics, k-means, dead-code thresholds and EMA over the global batch;
    the gradient averaged over the microbatches), with the activations of
    one microbatch. Returns (state, logs) as ``train_step``; logs['loss'] is
    the microbatches' mean dm_mse plus the global quantizer loss."""
    _unsharded(state, "train_step_accum")
    logs, vq_state, params = accum_grads(state, tcfg, batch, n_micro, rng=rng, **draws)
    return _finish_step(state, tc, params, vq_state, logs)


# elements of one all_reduce of the gradients: 256 MiB of fp32
GRAD_BUCKET = 1 << 26


def all_reduce_grads_(params, group, divisor):
    """Sum ``.grad`` over the ranks of ``group`` in place and divide by
    ``divisor``: flattened buckets of GRAD_BUCKET elements, one all_reduce
    each."""
    grads = [p.grad for p in params]
    i = 0
    while i < len(grads):
        j, n = i, 0
        while j < len(grads) and (j == i or n + grads[j].numel() <= GRAD_BUCKET):
            n += grads[j].numel()
            j += 1
        flat = torch.cat([g.reshape(-1) for g in grads[i:j]])
        dist.all_reduce(flat, group=group)
        flat.div_(divisor)
        o = 0
        for g in grads[i:j]:
            g.copy_(flat[o:o + g.numel()].view_as(g))
            o += g.numel()
        i = j


def dp_train_step(state: TokenizerTrainState, tcfg: TokenizerConfig, tc: TrainConfig,
                  local_batch, n_micro=1, group=None, rng=None, **global_draws):
    """One data-parallel optimizer step: ``train_step_accum`` with the
    global batch's microbatches placed on the ranks of ``group`` (the
    default group when None), n_micro of them on each rank. The pre-VQ
    outputs are gathered, phase A runs on the global batch (rank 0's result
    broadcast), each rank backpropagates its rows, the gradients are
    averaged by all_reduce over flattened buckets, and every rank clips and
    steps alike. Returns (state, logs) as ``train_step``.

    A sharded state (``make_train_state(..., mesh=)``) ignores ``group``:
    local_batch is then this rank's rows at its data x fsdp position
    (``state.sharding.local_rows``), the same on the ranks of a tensor
    group, and FSDP2 reduces the gradients."""
    if not dist.is_initialized():
        raise RuntimeError("dp_train_step needs an initialized process group "
                           "(parallel.distributed.init); train_step_accum is the one-device step")
    logs, vq_state, params = accum_grads(state, tcfg, local_batch, n_micro,
                                         group=dist.group.WORLD if group is None else group,
                                         rng=rng, **global_draws)
    return _finish_step(state, tc, params, vq_state, logs)


def _opt_names(state: TokenizerTrainState):
    """The parameter name of each index of the optimizer's state dict."""
    names = {id(p): n for n, p in state.model.named_parameters()}
    return [names[id(p)] for g in state.opt.param_groups for p in g["params"]]


def _map_opt_state(sd, names, fn):
    """The optimizer state dict ``sd`` with fn(name, tensor) applied to
    each moment (every state tensor but the scalar step)."""
    return {**sd, "state": {i: {k: fn(names[i], v) if torch.is_tensor(v) and v.ndim else v
                                for k, v in st.items()}
                            for i, st in sd["state"].items()}}


def train_state_tree(state: TokenizerTrainState):
    """The whole train state as ``save_train_state`` writes it: parameters,
    optimizer moments, VQ EMA buffers, EMA parameters, step; a sharded
    state's leaves gathered whole (a collective: every rank calls it)."""
    sh = state.sharding
    if sh is None:
        params, opt_state, ema = (state.model.state_dict(), state.opt.state_dict(),
                                  state.ema_params)
    else:
        params = {n: sh.full(n, p.detach()) for n, p in state.model.named_parameters()}
        opt_state = _map_opt_state(state.opt.state_dict(), _opt_names(state), sh.full)
        ema = None if state.ema_params is None else {
            n: sh.full(n, e) for n, e in state.ema_params.items()}
    tree = {"params": params, "opt_state": opt_state, "vq_state": state.vq_state.asdict(),
            "step": state.step}
    if ema is not None:
        tree["ema_params"] = ema
    return tree


def save_train_state(path, state: TokenizerTrainState, write=True):
    """Write the whole train state (``train_state_tree``): one unsharded
    file, whichever mesh the state is sharded over. Every rank of a sharded
    state calls it (the leaves are gathered); ``write`` False gathers
    without writing (the ranks but one)."""
    tree = train_state_tree(state)
    if write:
        save_checkpoint(path, tree)


def restore_train_state(path, like: TokenizerTrainState, exclude_opt=False):
    """Load a ``save_train_state`` file into ``like`` (a freshly built state
    of the same model, sharded over any mesh or not) and return it.
    ``exclude_opt`` keeps like's fresh optimizer state instead of the saved
    moments."""
    raw = restore_checkpoint(path)
    sh = like.sharding
    if sh is None:
        like.model.load_state_dict(raw["params"], strict=True)
    else:
        named = dict(like.model.named_parameters())
        if set(named) != set(raw["params"]):
            raise KeyError(f"{path}: the parameters differ from the model's: "
                           f"{sorted(set(named) ^ set(raw['params']))[:5]}")
        for n, p in named.items():
            sh.set_full_(n, p, raw["params"][n])
    if not exclude_opt:
        opt_state = raw["opt_state"]
        if sh is not None:
            names, named = _opt_names(like), dict(like.model.named_parameters())
            opt_state = _map_opt_state(opt_state, names,
                                       lambda n, v: sh.to_sharded(n, named[n], v))
        like.opt.load_state_dict(opt_state)
    dev = like.model.encoder.quantizer._codebook.embed.device
    like.vq_state = vq_mod.VQState(**raw["vq_state"]).to(dev)
    if like.ema_params is not None and raw.get("ema_params") is not None:
        for k, e in like.ema_params.items():
            if sh is None:
                e.copy_(raw["ema_params"][k])
            else:
                sh.set_full_(k, e, raw["ema_params"][k])
    like.step = int(raw["step"])
    return like


# ---------------------------------------------------------------------------
# renderer
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class RendererTrainState:
    """Only the renderer MMDiT trains; the tokenizer's encoder is frozen and
    travels outside the state."""
    model: MMDiT
    opt: torch.optim.Optimizer
    ema_params: Optional[dict]
    step: int = 0

    def release(self):
        self.model = self.opt = self.ema_params = None


def make_renderer_train_state(model: MMDiT, tc: TrainConfig):
    return RendererTrainState(
        model=model, opt=make_optimizer(model, tc, groups=False),
        ema_params=_ema_copy(model) if tc.ema_decay > 0 else None)


def renderer_grads(state: RendererTrainState, tcfg: TokenizerConfig, encoder: QformerEncoder,
                   batch):
    """The renderer step's forward and backward without the update:
    gradients into ``.grad``. Returns (loss, log_dict, params)."""
    state.model.train()
    loss, logs = renderer_train_loss(state.model, encoder, tcfg, batch)
    return loss, logs, backward_into_grads(state.model, loss)


def renderer_train_step(state: RendererTrainState, tcfg: TokenizerConfig, tc: TrainConfig,
                        encoder: QformerEncoder, batch):
    """One renderer optimizer step over the frozen encoder's tokens."""
    _, logs, params = renderer_grads(state, tcfg, encoder, batch)
    norm = apply_update(state.opt, params, tc, state.step)
    if state.ema_params is not None:
        ema_update(state.ema_params, dict(state.model.named_parameters()), tc.ema_decay)
    state.step += 1
    logs = dict(logs)
    logs["grad_norm"] = norm
    return state, logs
