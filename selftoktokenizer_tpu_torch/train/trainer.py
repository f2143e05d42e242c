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
"""

from __future__ import annotations

import dataclasses
import math
from typing import Optional

import torch

from selftoktokenizer_tpu_torch.core.checkpoint import (
    ema_update, restore_checkpoint, save_checkpoint)
from selftoktokenizer_tpu_torch.models import vq as vq_mod
from selftoktokenizer_tpu_torch.models.encoder import QformerEncoder
from selftoktokenizer_tpu_torch.models.mmdit import MMDiT
from selftoktokenizer_tpu_torch.models.tokenizer import (
    ImageTokenizer, TokenizerConfig, renderer_train_loss, tokenizer_loss)


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


@torch.no_grad()
def apply_update(opt, params, tc: TrainConfig, step):
    """One optimizer step from the gradients in ``.grad``: clip by one
    global norm over all ``params`` (g * max/norm where norm >= max), set
    each group's learning rate for ``step``, step. Returns the norm before
    clipping."""
    grads = [p.grad for p in params]
    norm = global_norm(grads)
    if tc.grad_norm > 0 and float(norm) >= tc.grad_norm:
        for g in grads:
            g.div_(norm.to(g.dtype)).mul_(tc.grad_norm)
    for group in opt.param_groups:
        group["lr"] = lr_at(group["base_lr"], tc, step)
    opt.step()
    return norm


def _backward(module, loss):
    """Gradients of loss into ``.grad`` of the trainable parameters; a
    parameter the loss does not reach gets zeros, as a gradient tree
    would, so weight decay treats every parameter alike."""
    params = [p for _, p in _trainable(module)]
    for p in params:
        p.grad = None
    loss.backward()
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

    def release(self):
        """Drop the references to the modules, the optimizer and the
        states, so their device memory can be given back."""
        self.model = self.opt = self.vq_state = self.ema_params = None


def _ema_copy(module):
    return {n: p.detach().clone() for n, p in module.named_parameters()}


def make_train_state(tok: ImageTokenizer, tcfg: TokenizerConfig, tc: TrainConfig,
                     vq_state=None):
    """A fresh train state over ``tok`` (trained in place). vq_state: the
    quantizer's EMA state to start from (a checkpoint's), else a fresh one."""
    if vq_state is None:
        vq_state = vq_mod.vq_state_init(tok.encoder.quantizer, tcfg.k)
    dev = tok.encoder.quantizer.embed.device
    return TokenizerTrainState(
        model=tok, opt=make_optimizer(tok, tc), vq_state=vq_state.to(dev),
        ema_params=_ema_copy(tok) if tc.ema_decay > 0 else None)


def tokenizer_grads(state: TokenizerTrainState, tcfg: TokenizerConfig, batch, rng=None,
                    **draws):
    """The step's forward and backward without the update: gradients into
    ``.grad``. Returns (loss, aux, params) with aux as ``tokenizer_loss``
    gives it. draws: explicit t, noise, drop_ids, gumbel_noise,
    kmeans_idx, react_uniforms, warm_ids."""
    state.model.train()
    loss, aux = tokenizer_loss(state.model, tcfg, batch, rng=rng, vq_state=state.vq_state,
                               **draws)
    return loss, aux, _backward(state.model, loss)


def train_step(state: TokenizerTrainState, tcfg: TokenizerConfig, tc: TrainConfig, batch,
               rng=None, **draws):
    """One optimizer step over the batch (NHWC latents [B,h,w,C]). Returns
    (state, logs): the loss's log dict, the gradients' global norm before
    clipping (``grad_norm``) and the step's token ids (``ids``). The
    gradients stay in ``.grad`` until the next step."""
    _, aux, params = tokenizer_grads(state, tcfg, batch, rng=rng, **draws)
    norm = apply_update(state.opt, params, tc, state.step)
    # the EMA-updated codebook is authoritative: the encode path reads it
    state.vq_state = aux["vq_state"]
    with torch.no_grad():
        state.model.encoder.quantizer._codebook.embed[0].copy_(state.vq_state.embed)
    if state.ema_params is not None:
        ema_update(state.ema_params, dict(state.model.named_parameters()), tc.ema_decay)
    state.step += 1
    logs = dict(aux["log_dict"])
    logs["grad_norm"] = norm
    logs["ids"] = aux["ids"]
    return state, logs


def save_train_state(path, state: TokenizerTrainState):
    """Write the whole train state: parameters, optimizer moments, VQ EMA
    buffers, EMA parameters, step."""
    tree = {"params": state.model.state_dict(), "opt_state": state.opt.state_dict(),
            "vq_state": state.vq_state.asdict(), "step": state.step}
    if state.ema_params is not None:
        tree["ema_params"] = state.ema_params
    save_checkpoint(path, tree)


def restore_train_state(path, like: TokenizerTrainState, exclude_opt=False):
    """Load a ``save_train_state`` file into ``like`` (a freshly built state
    of the same model) and return it. ``exclude_opt`` keeps like's fresh
    optimizer state instead of the saved moments."""
    raw = restore_checkpoint(path)
    like.model.load_state_dict(raw["params"], strict=True)
    if not exclude_opt:
        like.opt.load_state_dict(raw["opt_state"])
    dev = like.model.encoder.quantizer.embed.device
    like.vq_state = vq_mod.VQState(**raw["vq_state"]).to(dev)
    if like.ema_params is not None and raw.get("ema_params") is not None:
        for k, e in like.ema_params.items():
            e.copy_(raw["ema_params"][k])
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
    return loss, logs, _backward(state.model, loss)


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
