"""Rectified flow: validation schedules, the Euler sampler and the
flow-matching training loss (counterpart of the reference ``models/flow.py``).

The sampler is a Python loop over the steps. The per-step token counts
``k_i = diti.to_indices(timestep_map[i])`` are precomputed into a [steps]
table and the token mask is ``arange(K) <= k_i`` (inclusive). Schedules are
numpy fp32 ``linspace``, as in the reference.
"""

from __future__ import annotations

import numpy as np
import torch

TRADITION = 1000.0


def shift_t(t, shift):
    """t -> shift*t / (1 + (shift-1)*t)."""
    return shift * t / (1 + (shift - 1) * t)


def make_schedule(num_timesteps, start=1.0, schedule="uniform", shift=1.0,
                  align_args=None):
    """Validation schedules. Returns dict of np.float32 arrays:
    scheduled_t, scheduled_t_prev, timestep_map."""
    base_t = np.linspace(start, 0.0, num_timesteps + 1, dtype=np.float32)
    if schedule == "uniform":
        scheduled = base_t
    elif schedule == "shift":
        scheduled = shift * base_t / (1 + (shift - 1) * base_t)
    elif schedule == "align_resolution":
        res1, s1, res2, s2, target_res, c = align_args
        m = (s1 - s2) / (res1 - res2) * (target_res - res1) + s1
        e = np.e
        scheduled = e ** m / (e ** m + (1 / base_t - 1) ** c)
    else:
        raise ValueError(schedule)
    return {
        "scheduled_t": scheduled[:-1].astype(np.float32),
        "scheduled_t_prev": scheduled[1:].astype(np.float32),
        "timestep_map": (scheduled[:-1] * TRADITION).astype(np.float32),
    }


def q_sample(x, t, noise):
    """x_t = t*noise + (1-t)*x."""
    t = t.reshape(t.shape[0], *([1] * (x.ndim - 1)))
    return t * noise + (1 - t) * x


def euler_step(x, v, a_t, a_prev, parameterization="velocity"):
    if parameterization == "velocity":
        x_prev = x - (a_t - a_prev) * v
        pred_x0 = x - a_t * v
    elif parameterization == "x0":
        x_prev = v + a_prev * (x - v) / a_t
        pred_x0 = v
    else:
        raise ValueError(parameterization)
    return x_prev, pred_x0


def precompute_step_k(diti, sched, t2k=1.0):
    """Per-step token index table [steps] int32."""
    tm = sched["timestep_map"]
    if getattr(diti, "stages", None) is not None:
        # the reference casts to .long() first (truncation)
        t_tmp = np.trunc(tm).astype(np.float32)
    else:
        t_tmp = np.clip(t2k * (tm / 1000.0), 0, 1.0)
    return diti.to_indices(torch.from_numpy(t_tmp)).numpy().astype(np.int32)


def p_sample_loop(model_fn, sched, noise, encoder_hidden_states, step_k=None,
                  K=512, cfg_scale=1.0, uncond_fn=None, super_mask=None,
                  parameterization="velocity", shift=1.0, cond_vary=True,
                  cfg_pair_fn=None):
    """Euler sampler.

    model_fn(x, t, ehs, mask) -> velocity. noise: NHWC [B,h,w,C] fp32;
    encoder_hidden_states: [B,K,D]; step_k: [steps] int per-step token count
    table (from precompute_step_k). Under cfg_scale != 1 the unconditional
    branch ``uncond_fn`` runs first, then the conditional one; or, with
    cfg_pair_fn(x, t, ehs, mask) -> (v_cond, v_uncond), both in one call
    (``mmdit.mmdit_cfg_batched``). The schedule scalars are fp32, and so is
    the state. Returns the final latent.
    """
    steps = sched["scheduled_t"].shape[0]
    B = noise.shape[0]
    dev = noise.device
    sched_t = torch.from_numpy(np.asarray(sched["scheduled_t"], np.float32)).to(dev)
    sched_prev = torch.from_numpy(np.asarray(sched["scheduled_t_prev"], np.float32)).to(dev)
    if step_k is None:
        cond_vary = False
    else:
        step_k = np.asarray(step_k)
    kr = torch.arange(K, device=dev)
    ones = torch.ones((B, K), dtype=torch.bool, device=dev)

    img = noise
    for i in range(steps):
        t_raw = sched_t[i].expand(B)
        if cond_vary:
            mask = (kr[None, :] <= int(step_k[i])).expand(B, K)
            t = shift_t(t_raw, shift)
        else:
            mask = ones
            t = t_raw
        if super_mask is not None:
            mask = mask & super_mask
        if cfg_scale == 1.0:
            v = model_fn(img, t, encoder_hidden_states, mask)
        elif cfg_pair_fn is not None:
            v_c, v_un = cfg_pair_fn(img, t, encoder_hidden_states, mask)
            v = v_un + cfg_scale * (v_c - v_un)
        else:
            v_un = uncond_fn(img, t, encoder_hidden_states, mask)
            v_c = model_fn(img, t, encoder_hidden_states, mask)
            v = v_un + cfg_scale * (v_c - v_un)
        img, _ = euler_step(img, v, sched_t[i], sched_prev[i], parameterization)
    return img


# ---------------------------------------------------------------------------
# Training losses
# ---------------------------------------------------------------------------

def mean_flat(t):
    return torch.mean(t.reshape(t.shape[0], -1), dim=1)


def sum_flat(t):
    return torch.sum(t.reshape(t.shape[0], -1), dim=1)


def training_losses(model_fn, x_start, t, noise, parameterization="velocity",
                    force_recon=False, recon_ratio=1.0, loss_mask=None,
                    drop_ids=None):
    """Flow-matching loss and its stratified logging.

    model_fn(x_t, t) -> velocity (the caller closes over the conditioning).
    Returns a dict with 'loss' and 'mse' per sample and the scalars 'small'
    (t <= 0.35), 'mid', 'large' (t > 0.7) and 'uncon' (the dropped samples'
    mse) of the mse."""
    x_t = q_sample(x_start, t, noise)
    if parameterization == "x0":
        target = x_start
    elif parameterization == "eps":
        target = noise
    elif parameterization == "velocity":
        target = noise - x_start
    else:
        raise NotImplementedError(parameterization)

    v = model_fn(x_t, t)
    v_gt = noise - x_start
    if force_recon:
        model_output = x_t - t.reshape(-1, *([1] * (x_t.ndim - 1))) * v
        target = x_start
    else:
        model_output = v

    terms = {}
    se = (target - model_output) ** 2
    if loss_mask is not None:
        lm = loss_mask[:, :, :, None].expand(se.shape).to(se.dtype)
        terms["loss"] = sum_flat(se * lm) / sum_flat(lm)
    else:
        terms["loss"] = mean_flat(se)
    mse = mean_flat(se)
    terms["mse"] = mse

    def strat(cond):
        n = torch.sum(cond)
        m = torch.sum(torch.where(cond, mse, 0.0)) / torch.clamp(n, min=1)
        return torch.where(n > 0, m, torch.zeros_like(m))

    terms["small"] = strat(t <= 0.35)
    terms["mid"] = strat((t > 0.35) & (t <= 0.7))
    terms["large"] = strat(t > 0.7)
    terms["uncon"] = (torch.zeros((), device=mse.device) if drop_ids is None
                      else strat(drop_ids))
    if recon_ratio != 1.0 and force_recon:
        terms["loss"] = (recon_ratio * terms["loss"]
                         + (1 - recon_ratio) * mean_flat((v_gt - v) ** 2))
    return terms
