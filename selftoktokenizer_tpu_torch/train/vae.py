"""The SD3 VAE's trainer (counterpart of the reference ``train/vae.py``).

Objective: L1 + MSE reconstruction plus a KL term in LDM's proportions (the
per-image KL sum over the latent, over the image's pixel count, weighted by
``kl_weight``); no adversarial or perceptual term. Parameters are fp32, the
forward and backward run in bf16 (each weight cast at use), the moments and
the loss terms in fp32, GroupNorm statistics in fp32. Adam (eps 1e-8) with
a linear warmup and a cosine decay to ``lr * end_lr_ratio``, the gradients
clipped by one global norm. ``conv_in`` stays a plain convolution, as in the
reference (the 3-channel kernel has no backward).

A step mutates the state it is given and returns it with its log dict.
The reparametrisation noise is an explicit input or comes from the
``torch.Generator`` passed as ``rng``.
"""

from __future__ import annotations

import dataclasses
import math

import torch

from selftoktokenizer_tpu_torch.core.checkpoint import restore_checkpoint, save_checkpoint
from selftoktokenizer_tpu_torch.models.vae import (
    SDVAE, VAEConfig, vae_decode, vae_encode_mode, vae_encode_moments)
from selftoktokenizer_tpu_torch.train.trainer import backward_into_grads, clip_by_global_norm_
from selftoktokenizer_tpu_torch.utils.metrics import psnr, ssim


@dataclasses.dataclass
class VAETrainConfig:
    lr: float = 1e-4
    warmup_steps: int = 500
    max_steps: int = 20000
    kl_weight: float = 1e-6
    l1_weight: float = 1.0
    mse_weight: float = 1.0
    grad_norm: float = 1.0
    b1: float = 0.9
    b2: float = 0.999
    end_lr_ratio: float = 0.1      # the cosine's floor as a fraction of lr


@dataclasses.dataclass
class VAETrainState:
    model: SDVAE
    opt: torch.optim.Optimizer
    step: int = 0


def vae_lr_at(tc: VAETrainConfig, step):
    """The learning rate of the update made at ``step`` (0 for the first,
    whose rate is 0 with a warmup): linear from 0 over ``warmup`` steps,
    warmup = min(warmup_steps, max(max_steps // 10, 1)), then a cosine from
    lr to lr * end_lr_ratio at max_steps, held after."""
    warmup = min(tc.warmup_steps, max(tc.max_steps // 10, 1))
    if step < warmup:
        return tc.lr * step / warmup
    span = tc.max_steps - warmup
    if span <= 0:
        raise ValueError(f"VAETrainConfig: max_steps {tc.max_steps} leaves no decay after "
                         f"{warmup} warmup steps")
    frac = min(step - warmup, span) / span
    alpha = tc.end_lr_ratio
    return tc.lr * ((1 - alpha) * 0.5 * (1 + math.cos(math.pi * frac)) + alpha)


# the forward's and backward's type; parameters, moments and loss terms fp32
COMPUTE_DTYPE = torch.bfloat16


def make_vae_optimizer(vae: SDVAE, tc: VAETrainConfig):
    return torch.optim.Adam(vae.parameters(), lr=tc.lr, betas=(tc.b1, tc.b2), eps=1e-8)


def make_vae_train_state(vae: SDVAE, tc: VAETrainConfig):
    """A fresh train state over ``vae`` (trained in place)."""
    return VAETrainState(model=vae, opt=make_vae_optimizer(vae, tc))


def vae_loss(vae: SDVAE, cfg: VAEConfig, x, tc: VAETrainConfig, noise=None, rng=None):
    """x: NHWC images [B,H,W,3] in [-1, 1], fp32. Encode to moments, sample
    z = mean + std * noise (noise: the latent-shaped normal draw, else
    drawn from rng), decode, L1 + MSE + KL; the forward in COMPUTE_DTYPE.
    Returns (loss, logs)."""
    mean, logvar = vae_encode_moments(vae, cfg, x.to(COMPUTE_DTYPE))
    mean32, logvar32 = mean.float(), logvar.float()
    if noise is None:
        if rng is None:
            raise ValueError("vae_loss: pass noise or rng (a torch.Generator)")
        noise = torch.randn(mean32.shape, generator=rng, device=x.device)
    z = mean32 + torch.exp(0.5 * logvar32) * noise.to(x.device)
    recon = vae_decode(vae, cfg, z.to(COMPUTE_DTYPE)).float()

    l1 = torch.mean(torch.abs(recon - x))
    mse = torch.mean((recon - x) ** 2)
    kl_per_image = -0.5 * torch.sum(1.0 + logvar32 - mean32 ** 2 - torch.exp(logvar32),
                                    dim=(1, 2, 3))
    kl = torch.mean(kl_per_image) / (x.shape[1] * x.shape[2] * x.shape[3])
    loss = tc.l1_weight * l1 + tc.mse_weight * mse + tc.kl_weight * kl
    logs = {"loss": loss, "l1": l1, "mse": mse, "kl": kl,
            "latent_std": torch.std(mean32, unbiased=False),
            "latent_absmean": torch.mean(torch.abs(mean32))}
    return loss, {k: v.detach() for k, v in logs.items()}


def vae_train_step(state: VAETrainState, cfg: VAEConfig, tc: VAETrainConfig, batch, noise=None,
                   rng=None):
    """One optimizer step over the image batch. Returns (state, logs) with
    the gradients' global norm before clipping (``grad_norm``)."""
    state.model.train()
    loss, logs = vae_loss(state.model, cfg, batch, tc, noise=noise, rng=rng)
    params = backward_into_grads(state.model, loss)
    with torch.no_grad():
        logs["grad_norm"] = clip_by_global_norm_([p.grad for p in params], tc.grad_norm)
        for group in state.opt.param_groups:
            group["lr"] = vae_lr_at(tc, state.step)
        state.opt.step()
    state.step += 1
    return state, logs


@torch.no_grad()
def vae_eval_psnr(vae: SDVAE, cfg: VAEConfig, x):
    """Deterministic encode -> decode in bf16 (the pipeline's mode): mean
    PSNR and SSIM over the batch on the [0, 1] range. x in [-1, 1]."""
    z = vae_encode_mode(vae, cfg, x.to(torch.bfloat16))
    recon = vae_decode(vae, cfg, z).float()
    a = torch.clamp((x.float() + 1) / 2, 0, 1)
    b = torch.clamp((recon + 1) / 2, 0, 1)
    return torch.mean(psnr(a, b)), torch.mean(ssim(a, b))


def save_vae_state(path, state: VAETrainState, cfg: VAEConfig):
    """Parameters, optimizer state, step and the widths that rebuild the
    VAE, in one checkpoint file."""
    save_checkpoint(path, {
        "params": state.model.state_dict(), "opt_state": state.opt.state_dict(),
        "step": state.step,
        "config": {"ch": cfg.ch, "ch_mult": list(cfg.ch_mult),
                   "num_res_blocks": cfg.num_res_blocks, "z_channels": cfg.z_channels}})


def load_vae_params(path):
    """(SDVAE on the CPU with the saved parameters, its VAEConfig) from a
    ``save_vae_state`` file."""
    tree = restore_checkpoint(path)
    c = tree["config"]
    cfg = VAEConfig(ch=int(c["ch"]), ch_mult=tuple(int(m) for m in c["ch_mult"]),
                    num_res_blocks=int(c["num_res_blocks"]), z_channels=int(c["z_channels"]))
    vae = SDVAE(cfg)
    vae.load_state_dict(tree["params"], strict=True)
    return vae, cfg

