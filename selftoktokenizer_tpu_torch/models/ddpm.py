"""The DDPM stack of the ADM family: Gaussian diffusion, timestep respacing,
the variational-bound terms, DDIM and the schedule samplers (counterpart of
the reference ``models/ddpm.py``).

Feature maps are NHWC, so a learned variance is the last axis's second
half. The schedules and every table are float64 numpy, as in the
reference, and are cast to float32 only where a step reads them
(``_extract``). The sampler loops are Python loops over tensors. Every
random draw is an input or comes from an explicit ``torch.Generator``:
``noise`` starts a loop, ``step_noises`` (one tensor a step, in the loop's
order) feed its steps, and ``rng`` draws whatever is not given.
"""

from __future__ import annotations

import enum
import math

import numpy as np
import torch


class ModelMeanType(enum.Enum):
    PREVIOUS_X = enum.auto()
    START_X = enum.auto()
    EPSILON = enum.auto()


class ModelVarType(enum.Enum):
    LEARNED = enum.auto()
    FIXED_SMALL = enum.auto()
    FIXED_LARGE = enum.auto()
    LEARNED_RANGE = enum.auto()


class LossType(enum.Enum):
    MSE = enum.auto()
    RESCALED_MSE = enum.auto()
    KL = enum.auto()
    RESCALED_KL = enum.auto()

    def is_vb(self):
        return self in (LossType.KL, LossType.RESCALED_KL)


# ---------------------------------------------------------------------------
# beta schedules
# ---------------------------------------------------------------------------

def _warmup_beta(beta_start, beta_end, n, warmup_frac):
    betas = beta_end * np.ones(n, dtype=np.float64)
    warmup_time = int(n * warmup_frac)
    betas[:warmup_time] = np.linspace(beta_start, beta_end, warmup_time, dtype=np.float64)
    return betas


def get_beta_schedule(beta_schedule, *, beta_start, beta_end, num_diffusion_timesteps):
    n = num_diffusion_timesteps
    if beta_schedule == "quad":
        return np.linspace(beta_start ** 0.5, beta_end ** 0.5, n, dtype=np.float64) ** 2
    if beta_schedule == "linear":
        return np.linspace(beta_start, beta_end, n, dtype=np.float64)
    if beta_schedule == "warmup10":
        return _warmup_beta(beta_start, beta_end, n, 0.1)
    if beta_schedule == "warmup50":
        return _warmup_beta(beta_start, beta_end, n, 0.5)
    if beta_schedule == "const":
        return beta_end * np.ones(n, dtype=np.float64)
    if beta_schedule == "jsd":
        return 1.0 / np.linspace(n, 1, n, dtype=np.float64)
    raise NotImplementedError(beta_schedule)


def get_named_beta_schedule(schedule_name, num_diffusion_timesteps):
    if schedule_name == "linear":
        scale = 1000 / num_diffusion_timesteps
        return get_beta_schedule("linear", beta_start=scale * 0.0001, beta_end=scale * 0.02,
                                 num_diffusion_timesteps=num_diffusion_timesteps)
    if schedule_name == "squaredcos_cap_v2":
        return betas_for_alpha_bar(
            num_diffusion_timesteps, lambda t: math.cos((t + 0.008) / 1.008 * math.pi / 2) ** 2)
    raise NotImplementedError(f"unknown beta schedule: {schedule_name}")


def betas_for_alpha_bar(n, alpha_bar, max_beta=0.999):
    return np.array([min(1 - alpha_bar((i + 1) / n) / alpha_bar(i / n), max_beta)
                     for i in range(n)])


# ---------------------------------------------------------------------------
# likelihood utilities
# ---------------------------------------------------------------------------

def normal_kl(mean1, logvar1, mean2, logvar2):
    """KL of two Gaussians, elementwise; mean2 / logvar2 may be floats."""
    mean2 = torch.as_tensor(mean2, dtype=mean1.dtype, device=mean1.device)
    logvar2 = torch.as_tensor(logvar2, dtype=mean1.dtype, device=mean1.device)
    return 0.5 * (-1.0 + logvar2 - logvar1 + torch.exp(logvar1 - logvar2)
                  + ((mean1 - mean2) ** 2) * torch.exp(-logvar2))


def approx_standard_normal_cdf(x):
    return 0.5 * (1.0 + torch.tanh(float(np.sqrt(2.0 / np.pi)) * (x + 0.044715 * x ** 3)))


def discretized_gaussian_log_likelihood(x, *, means, log_scales):
    centered = x - means
    inv_stdv = torch.exp(-log_scales)
    cdf_plus = approx_standard_normal_cdf(inv_stdv * (centered + 1.0 / 255.0))
    cdf_min = approx_standard_normal_cdf(inv_stdv * (centered - 1.0 / 255.0))
    log_cdf_plus = torch.log(torch.clamp(cdf_plus, min=1e-12))
    log_om_cdf_min = torch.log(torch.clamp(1.0 - cdf_min, min=1e-12))
    log_delta = torch.log(torch.clamp(cdf_plus - cdf_min, min=1e-12))
    return torch.where(x < -0.999, log_cdf_plus,
                       torch.where(x > 0.999, log_om_cdf_min, log_delta))


def mean_flat(t):
    return torch.mean(t.reshape(t.shape[0], -1), dim=1)


def _extract(arr, t, shape):
    """arr[t] of a float64 table, cast to float32 here, shaped to broadcast
    against ``shape``."""
    out = torch.as_tensor(np.asarray(arr, np.float32), device=t.device)[t.long()]
    return out.reshape(t.shape[0], *([1] * (len(shape) - 1)))


def _normal(shape, rng, like):
    if rng is None:
        raise ValueError("pass the noise or rng (a torch.Generator)")
    return torch.randn(shape, generator=rng, device=rng.device, dtype=like.dtype).to(like.device)


def _steps(step_noises, i):
    return None if step_noises is None else step_noises[i]


# ---------------------------------------------------------------------------
# GaussianDiffusion
# ---------------------------------------------------------------------------

class GaussianDiffusion:
    def __init__(self, *, betas, model_mean_type: ModelMeanType,
                 model_var_type: ModelVarType, loss_type: LossType):
        self.model_mean_type = model_mean_type
        self.model_var_type = model_var_type
        self.loss_type = loss_type
        betas = np.array(betas, dtype=np.float64)
        assert betas.ndim == 1 and (betas > 0).all() and (betas <= 1).all()
        self.betas = betas
        self.num_timesteps = int(betas.shape[0])

        alphas = 1.0 - betas
        self.alphas_cumprod = np.cumprod(alphas, axis=0)
        self.alphas_cumprod_prev = np.append(1.0, self.alphas_cumprod[:-1])
        self.alphas_cumprod_next = np.append(self.alphas_cumprod[1:], 0.0)
        self.sqrt_alphas_cumprod = np.sqrt(self.alphas_cumprod)
        self.sqrt_one_minus_alphas_cumprod = np.sqrt(1.0 - self.alphas_cumprod)
        self.log_one_minus_alphas_cumprod = np.log(1.0 - self.alphas_cumprod)
        self.sqrt_recip_alphas_cumprod = np.sqrt(1.0 / self.alphas_cumprod)
        self.sqrt_recipm1_alphas_cumprod = np.sqrt(1.0 / self.alphas_cumprod - 1)

        self.posterior_variance = (
            betas * (1.0 - self.alphas_cumprod_prev) / (1.0 - self.alphas_cumprod))
        self.posterior_log_variance_clipped = np.log(
            np.append(self.posterior_variance[1], self.posterior_variance[1:])
        ) if len(self.posterior_variance) > 1 else np.array([])
        self.posterior_mean_coef1 = (
            betas * np.sqrt(self.alphas_cumprod_prev) / (1.0 - self.alphas_cumprod))
        self.posterior_mean_coef2 = (
            (1.0 - self.alphas_cumprod_prev) * np.sqrt(alphas) / (1.0 - self.alphas_cumprod))

        snr = self.alphas_cumprod / (1.0 - self.alphas_cumprod)
        self.weight = snr ** 0.1 / (1.0 + snr)

        # the jump posterior q(x_{t-n} | x_t, x_0): the reference's recurrence,
        # one diagonal at a time
        T = self.num_timesteps
        a = np.full((T, T), np.inf)
        b = np.full((T, T), np.inf)
        np.fill_diagonal(a, self.posterior_mean_coef1)
        np.fill_diagonal(b, self.posterior_mean_coef2)
        for i in range(1, T):
            j = np.arange(0, T - i)
            a[j, j + i] = a[j, j + i - 1] + b[j, j + i - 1] * self.posterior_mean_coef1[j + i]
            b[j, j + i] = b[j, j + i - 1] * self.posterior_mean_coef2[j + i]
        self.posterior_mean_jump_coef1 = a
        self.posterior_mean_jump_coef2 = b

    # -- q distributions ----------------------------------------------------

    def q_mean_variance(self, x_start, t):
        mean = _extract(self.sqrt_alphas_cumprod, t, x_start.shape) * x_start
        variance = _extract(1.0 - self.alphas_cumprod, t, x_start.shape)
        log_variance = _extract(self.log_one_minus_alphas_cumprod, t, x_start.shape)
        return mean, variance, log_variance

    def q_sample(self, x_start, t, noise):
        return (_extract(self.sqrt_alphas_cumprod, t, x_start.shape) * x_start
                + _extract(self.sqrt_one_minus_alphas_cumprod, t, x_start.shape) * noise)

    def q_posterior_mean_variance(self, x_start, x_t, t):
        mean = (_extract(self.posterior_mean_coef1, t, x_t.shape) * x_start
                + _extract(self.posterior_mean_coef2, t, x_t.shape) * x_t)
        var = _extract(self.posterior_variance, t, x_t.shape)
        logvar = _extract(self.posterior_log_variance_clipped, t, x_t.shape)
        return mean, var, logvar

    def q_posterior_mean_jump(self, x_start, x_t, t, target_t):
        shape = (-1,) + (1,) * (x_t.ndim - 1)
        idx = ((target_t + 1).long().cpu().numpy(), t.long().cpu().numpy())
        c1 = torch.as_tensor(np.asarray(self.posterior_mean_jump_coef1, np.float32)[idx],
                             device=x_t.device).reshape(shape)
        c2 = torch.as_tensor(np.asarray(self.posterior_mean_jump_coef2, np.float32)[idx],
                             device=x_t.device).reshape(shape)
        return c1 * x_start + c2 * x_t

    # -- model wrappers -----------------------------------------------------

    def _predict_xstart_from_eps(self, x_t, t, eps):
        return (_extract(self.sqrt_recip_alphas_cumprod, t, x_t.shape) * x_t
                - _extract(self.sqrt_recipm1_alphas_cumprod, t, x_t.shape) * eps)

    def _predict_eps_from_xstart(self, x_t, t, pred_xstart):
        return ((_extract(self.sqrt_recip_alphas_cumprod, t, x_t.shape) * x_t - pred_xstart)
                / _extract(self.sqrt_recipm1_alphas_cumprod, t, x_t.shape))

    def p_mean_variance(self, model, x, t, clip_denoised=True, denoised_fn=None,
                        model_kwargs=None, target_t=None):
        """A learned variance is the last axis's second half (NHWC)."""
        model_output = model(x, t, **(model_kwargs or {}))
        if isinstance(model_output, tuple):
            model_output = model_output[0]
        if self.model_var_type in (ModelVarType.LEARNED, ModelVarType.LEARNED_RANGE):
            model_output, model_var_values = torch.chunk(model_output, 2, dim=-1)
            min_log = _extract(self.posterior_log_variance_clipped, t, x.shape)
            max_log = _extract(np.log(self.betas), t, x.shape)
            frac = (model_var_values + 1) / 2
            model_log_variance = frac * max_log + (1 - frac) * min_log
            model_variance = torch.exp(model_log_variance)
        else:
            if self.model_var_type == ModelVarType.FIXED_LARGE:
                var = np.append(self.posterior_variance[1], self.betas[1:])
                logvar = np.log(var)
            else:
                var, logvar = self.posterior_variance, self.posterior_log_variance_clipped
            model_variance = _extract(var, t, x.shape)
            model_log_variance = _extract(logvar, t, x.shape)

        def process_xstart(v):
            if denoised_fn is not None:
                v = denoised_fn(v)
            return torch.clamp(v, -1, 1) if clip_denoised else v

        if self.model_mean_type == ModelMeanType.START_X:
            pred_xstart = process_xstart(model_output)
        else:
            pred_xstart = process_xstart(self._predict_xstart_from_eps(x, t, model_output))
        if target_t is None:
            model_mean, _, _ = self.q_posterior_mean_variance(pred_xstart, x, t)
        else:
            model_mean = self.q_posterior_mean_jump(pred_xstart, x, t, target_t)
        return {"mean": model_mean, "variance": model_variance,
                "log_variance": model_log_variance, "pred_xstart": pred_xstart}

    def condition_mean(self, cond_fn, p_mean_var, x, t, model_kwargs=None):
        gradient = cond_fn(x, t, **(model_kwargs or {}))
        return p_mean_var["mean"] + p_mean_var["variance"] * gradient

    def condition_score(self, cond_fn, p_mean_var, x, t, model_kwargs=None):
        alpha_bar = _extract(self.alphas_cumprod, t, x.shape)
        eps = self._predict_eps_from_xstart(x, t, p_mean_var["pred_xstart"])
        eps = eps - torch.sqrt(1 - alpha_bar) * cond_fn(x, t, **(model_kwargs or {}))
        out = dict(p_mean_var)
        out["pred_xstart"] = self._predict_xstart_from_eps(x, t, eps)
        out["mean"], _, _ = self.q_posterior_mean_variance(out["pred_xstart"], x, t)
        return out

    # -- ancestral sampling -------------------------------------------------

    def p_sample(self, model, x, t, noise=None, rng=None, clip_denoised=True,
                 denoised_fn=None, cond_fn=None, model_kwargs=None, target_t=None):
        out = self.p_mean_variance(model, x, t, clip_denoised, denoised_fn, model_kwargs,
                                   target_t)
        if cond_fn is not None:
            out["mean"] = self.condition_mean(cond_fn, out, x, t, model_kwargs)
        if noise is None:
            noise = _normal(x.shape, rng, x)
        nonzero = (t != 0).to(x.dtype).reshape(-1, *([1] * (x.ndim - 1)))
        sample = out["mean"] + nonzero * torch.exp(0.5 * out["log_variance"]) * noise
        return {"sample": sample, "pred_xstart": out["pred_xstart"]}

    def _ts(self, B, ti, device):
        return torch.full((B,), ti, dtype=torch.int64, device=device)

    def p_sample_loop_progressive(self, model, shape, rng=None, noise=None, step_noises=None,
                                  clip_denoised=True, denoised_fn=None, cond_fn=None,
                                  model_kwargs=None):
        """Yields each step's {'sample', 'pred_xstart'}, t = T-1 down to 0."""
        img = noise if noise is not None else torch.randn(shape, generator=rng,
                                                          device=rng.device)
        for i, ti in enumerate(range(self.num_timesteps - 1, -1, -1)):
            out = self.p_sample(model, img, self._ts(shape[0], ti, img.device),
                                _steps(step_noises, i), rng, clip_denoised, denoised_fn,
                                cond_fn, model_kwargs)
            yield out
            img = out["sample"]

    def p_sample_loop(self, model, shape, rng=None, noise=None, step_noises=None,
                      clip_denoised=True, denoised_fn=None, cond_fn=None, model_kwargs=None):
        """The full ancestral loop; returns the last sample."""
        img = noise
        for out in self.p_sample_loop_progressive(model, shape, rng, noise, step_noises,
                                                  clip_denoised, denoised_fn, cond_fn,
                                                  model_kwargs):
            img = out["sample"]
        return img

    # -- DDIM ---------------------------------------------------------------

    def ddim_sample(self, model, x, t, noise=None, rng=None, clip_denoised=True,
                    denoised_fn=None, cond_fn=None, model_kwargs=None, eta=0.0):
        out = self.p_mean_variance(model, x, t, clip_denoised, denoised_fn, model_kwargs)
        if cond_fn is not None:
            out = self.condition_score(cond_fn, out, x, t, model_kwargs)
        eps = self._predict_eps_from_xstart(x, t, out["pred_xstart"])
        alpha_bar = _extract(self.alphas_cumprod, t, x.shape)
        alpha_bar_prev = _extract(self.alphas_cumprod_prev, t, x.shape)
        sigma = (eta * torch.sqrt((1 - alpha_bar_prev) / (1 - alpha_bar))
                 * torch.sqrt(1 - alpha_bar / alpha_bar_prev))
        mean_pred = (out["pred_xstart"] * torch.sqrt(alpha_bar_prev)
                     + torch.sqrt(1 - alpha_bar_prev - sigma ** 2) * eps)
        nonzero = (t != 0).to(x.dtype).reshape(-1, *([1] * (x.ndim - 1)))
        if eta == 0.0 or (noise is None and rng is None):
            # no draw: the deterministic step (eta = 0) or zero noise
            return {"sample": mean_pred, "pred_xstart": out["pred_xstart"]}
        if noise is None:
            noise = _normal(x.shape, rng, x)
        return {"sample": mean_pred + nonzero * sigma * noise, "pred_xstart": out["pred_xstart"]}

    def ddim_reverse_sample(self, model, x, t, clip_denoised=True, denoised_fn=None,
                            model_kwargs=None, eta=0.0):
        assert eta == 0.0, "Reverse ODE only for deterministic path"
        out = self.p_mean_variance(model, x, t, clip_denoised, denoised_fn, model_kwargs)
        eps = self._predict_eps_from_xstart(x, t, out["pred_xstart"])
        alpha_bar_next = _extract(self.alphas_cumprod_next, t, x.shape)
        mean_pred = out["pred_xstart"] * torch.sqrt(alpha_bar_next) + torch.sqrt(
            1 - alpha_bar_next) * eps
        return {"sample": mean_pred, "pred_xstart": out["pred_xstart"]}

    def ddim_sample_loop(self, model, shape, rng=None, noise=None, step_noises=None,
                         clip_denoised=True, denoised_fn=None, cond_fn=None, model_kwargs=None,
                         eta=0.0):
        """The DDIM loop, t = T-1 down to 0; with eta = 0 it draws nothing
        after the start noise."""
        img = noise if noise is not None else torch.randn(shape, generator=rng,
                                                          device=rng.device)
        for i, ti in enumerate(range(self.num_timesteps - 1, -1, -1)):
            img = self.ddim_sample(model, img, self._ts(shape[0], ti, img.device),
                                   _steps(step_noises, i), rng, clip_denoised, denoised_fn,
                                   cond_fn, model_kwargs, eta)["sample"]
        return img

    def ddim_reverse_sample_loop(self, model, x, clip_denoised=True, denoised_fn=None,
                                 model_kwargs=None):
        """Data to latents along the reverse ODE, t = 0 up to T-1."""
        for ti in range(self.num_timesteps):
            x = self.ddim_reverse_sample(model, x, self._ts(x.shape[0], ti, x.device),
                                         clip_denoised, denoised_fn, model_kwargs)["sample"]
        return x

    # -- losses -------------------------------------------------------------

    def _vb_terms_bpd(self, model, x_start, x_t, t, clip_denoised=True, model_kwargs=None):
        """The variational-bound term in bits per dimension: the decoder's
        negative log-likelihood at t = 0, the KL elsewhere."""
        true_mean, _, true_logvar = self.q_posterior_mean_variance(x_start, x_t, t)
        out = self.p_mean_variance(model, x_t, t, clip_denoised, model_kwargs=model_kwargs)
        kl = mean_flat(normal_kl(true_mean, true_logvar, out["mean"], out["log_variance"])) \
            / np.log(2.0)
        decoder_nll = mean_flat(-discretized_gaussian_log_likelihood(
            x_start, means=out["mean"], log_scales=0.5 * out["log_variance"])) / np.log(2.0)
        return {"output": torch.where(t == 0, decoder_nll, kl), "pred_xstart": out["pred_xstart"]}

    def training_losses(self, model, x_start, t, rng=None, model_kwargs=None,
                        force_recon_loss=False, noise=None, weighting=False, x_t=None):
        """The loss terms at timesteps t [B]: 'mse', with a learned variance
        also 'vb' (its gradient reaches the variance half only), and their
        sum 'loss'; or the VB term alone for a KL loss type."""
        model_kwargs = model_kwargs or {}
        if noise is None:
            noise = _normal(x_start.shape, rng, x_start)
        if x_t is None:
            x_t = self.q_sample(x_start, t, noise)
        terms = {"x_t": x_t}
        if self.loss_type.is_vb():
            out = self._vb_terms_bpd(model, x_start, x_t, t, False, model_kwargs)
            terms["loss"] = out["output"]
            if self.loss_type == LossType.RESCALED_KL:
                terms["loss"] = terms["loss"] * self.num_timesteps
            terms["pred_xstart"] = out["pred_xstart"].detach()
            return terms

        model_output = model(x_t, t, **model_kwargs)
        if self.model_var_type in (ModelVarType.LEARNED, ModelVarType.LEARNED_RANGE):
            model_output, model_var_values = torch.chunk(model_output, 2, dim=-1)
            frozen = torch.cat([model_output.detach(), model_var_values], dim=-1)
            out = self._vb_terms_bpd(lambda *a, **k: frozen, x_start, x_t, t, False)
            terms["vb"] = out["output"]
            terms["pred_xstart"] = out["pred_xstart"].detach()
            if self.loss_type == LossType.RESCALED_MSE:
                terms["vb"] = terms["vb"] * (self.num_timesteps / 1000.0)
        if self.model_mean_type == ModelMeanType.START_X:
            terms["pred_xstart"] = model_output.detach()
        if self.model_mean_type == ModelMeanType.PREVIOUS_X:
            target = self.q_posterior_mean_variance(x_start, x_t, t)[0]
        elif self.model_mean_type == ModelMeanType.START_X:
            target = x_start
        else:
            target = noise
        if force_recon_loss:
            if self.model_mean_type == ModelMeanType.EPSILON:
                model_output = self._predict_xstart_from_eps(x_t, t, model_output)
            target = x_start
        se = (target - model_output) ** 2
        terms["mse"] = mean_flat(_extract(self.weight, t, target.shape) * se if weighting else se)
        terms["loss"] = terms["mse"] + terms["vb"] if "vb" in terms else terms["mse"]
        return terms

    def _prior_bpd(self, x_start):
        t = self._ts(x_start.shape[0], self.num_timesteps - 1, x_start.device)
        qt_mean, _, qt_log_variance = self.q_mean_variance(x_start, t)
        return mean_flat(normal_kl(qt_mean, qt_log_variance, 0.0, 0.0)) / np.log(2.0)

    def calc_bpd_loop(self, model, x_start, rng=None, step_noises=None, clip_denoised=True,
                      model_kwargs=None):
        """The whole chain's bound: each timestep's VB term and x_start MSE
        (t = T-1 down to 0, a noise draw each) and the prior's bits per
        dimension."""
        vb, mse = [], []
        for i, ti in enumerate(range(self.num_timesteps - 1, -1, -1)):
            t = self._ts(x_start.shape[0], ti, x_start.device)
            noise = _steps(step_noises, i)
            if noise is None:
                noise = _normal(x_start.shape, rng, x_start)
            x_t = self.q_sample(x_start, t, noise)
            out = self._vb_terms_bpd(model, x_start, x_t, t, clip_denoised, model_kwargs)
            vb.append(out["output"])
            mse.append(mean_flat((out["pred_xstart"] - x_start) ** 2))
        vb, mse = torch.stack(vb, dim=1), torch.stack(mse, dim=1)
        prior = self._prior_bpd(x_start)
        return {"total_bpd": torch.sum(vb, dim=1) + prior, "prior_bpd": prior, "vb": vb,
                "mse": mse}


# ---------------------------------------------------------------------------
# timestep respacing
# ---------------------------------------------------------------------------

def space_timesteps(num_timesteps, section_counts):
    """The timesteps kept out of num_timesteps: "ddimN" (an integer stride
    giving exactly N), or counts per equal section ("10,20" or a list)."""
    if isinstance(section_counts, str):
        if section_counts.startswith("ddim"):
            desired = int(section_counts[len("ddim"):])
            for i in range(1, num_timesteps):
                if len(range(0, num_timesteps, i)) == desired:
                    return set(range(0, num_timesteps, i))
            raise ValueError(f"cannot create exactly {num_timesteps} steps with an integer stride")
        section_counts = [int(x) for x in section_counts.split(",")]
    size_per = num_timesteps // len(section_counts)
    extra = num_timesteps % len(section_counts)
    start_idx, all_steps = 0, []
    for i, section_count in enumerate(section_counts):
        size = size_per + (1 if i < extra else 0)
        if size < section_count:
            raise ValueError(f"cannot divide section of {size} steps into {section_count}")
        frac_stride = 1 if section_count <= 1 else (size - 1) / (section_count - 1)
        cur = 0.0
        for _ in range(section_count):
            all_steps.append(start_idx + round(cur))
            cur += frac_stride
        start_idx += size
    return set(all_steps)


class SpacedDiffusion(GaussianDiffusion):
    """A diffusion over a subset of the base process's timesteps; the model
    is called at the original timesteps (``timestep_map``), remapped once
    however many of the wrappers below a call passes through."""

    def __init__(self, use_timesteps, **kwargs):
        self.use_timesteps = set(use_timesteps)
        self.timestep_map = []
        self.original_num_steps = len(kwargs["betas"])
        base = GaussianDiffusion(**kwargs)
        last, new_betas = 1.0, []
        for i, ac in enumerate(base.alphas_cumprod):
            if i in self.use_timesteps:
                new_betas.append(1 - ac / last)
                last = ac
                self.timestep_map.append(i)
        super().__init__(**dict(kwargs, betas=np.array(new_betas)))

    def _wrap_model(self, model):
        if getattr(model, "_ddpm_respaced", False):
            return model
        tmap = torch.as_tensor(self.timestep_map, dtype=torch.int64)

        def wrapped(x, ts, **kw):
            return model(x, tmap.to(ts.device)[ts.long()], **kw)

        wrapped._ddpm_respaced = True
        return wrapped

    def p_mean_variance(self, model, *args, **kwargs):
        return super().p_mean_variance(self._wrap_model(model), *args, **kwargs)

    def training_losses(self, model, *args, **kwargs):
        return super().training_losses(self._wrap_model(model), *args, **kwargs)

    def condition_mean(self, cond_fn, *args, **kwargs):
        return super().condition_mean(self._wrap_model(cond_fn), *args, **kwargs)

    def condition_score(self, cond_fn, *args, **kwargs):
        return super().condition_score(self._wrap_model(cond_fn), *args, **kwargs)


def create_diffusion(timestep_respacing, noise_schedule="linear", use_kl=False,
                     sigma_small=False, predict_xstart=False, learn_sigma=True,
                     rescale_learned_sigmas=False, diffusion_steps=1000, use_timesteps=None):
    betas = get_named_beta_schedule(noise_schedule, diffusion_steps)
    if use_kl:
        loss_type = LossType.RESCALED_KL
    elif rescale_learned_sigmas:
        loss_type = LossType.RESCALED_MSE
    else:
        loss_type = LossType.MSE
    if timestep_respacing is None or timestep_respacing == "":
        timestep_respacing = [diffusion_steps]
    timesteps = (space_timesteps(diffusion_steps, timestep_respacing)
                 if use_timesteps is None else use_timesteps)
    return SpacedDiffusion(
        use_timesteps=timesteps, betas=betas,
        model_mean_type=ModelMeanType.START_X if predict_xstart else ModelMeanType.EPSILON,
        model_var_type=(ModelVarType.LEARNED_RANGE if learn_sigma else
                        ModelVarType.FIXED_SMALL if sigma_small else ModelVarType.FIXED_LARGE),
        loss_type=loss_type)


# ---------------------------------------------------------------------------
# timestep samplers
# ---------------------------------------------------------------------------

def create_named_schedule_sampler(name, diffusion):
    if name == "uniform":
        return UniformSampler(diffusion)
    if name == "loss-second-moment":
        return LossSecondMomentResampler(diffusion)
    raise NotImplementedError(f"unknown schedule sampler: {name}")


class ScheduleSampler:
    def weights(self):
        raise NotImplementedError

    def sample(self, batch_size, rng=None):
        """(timesteps [batch_size] int64, importance weights float32), drawn
        with a numpy Generator."""
        w = self.weights()
        p = w / np.sum(w)
        rng = np.random.default_rng() if rng is None else rng
        idx = rng.choice(len(p), size=(batch_size,), p=p)
        weights = 1.0 / (len(p) * p[idx])
        return torch.as_tensor(idx, dtype=torch.int64), torch.as_tensor(weights,
                                                                         dtype=torch.float32)


class UniformSampler(ScheduleSampler):
    def __init__(self, diffusion):
        self._weights = np.ones([diffusion.num_timesteps])

    def weights(self):
        return self._weights


class LossAwareSampler(ScheduleSampler):
    def update_with_local_losses(self, local_ts, local_losses):
        """Gathers every rank's (timestep, loss) pairs when a process group
        of more than one rank is up, then updates from all of them."""
        import torch.distributed as dist

        ts = [int(t) for t in torch.as_tensor(local_ts).reshape(-1).tolist()]
        losses = [float(x) for x in torch.as_tensor(local_losses).reshape(-1).tolist()]
        if dist.is_available() and dist.is_initialized() and dist.get_world_size() > 1:
            gathered = [None] * dist.get_world_size()
            dist.all_gather_object(gathered, (ts, losses))
            ts = [t for g in gathered for t in g[0]]
            losses = [x for g in gathered for x in g[1]]
        self.update_with_all_losses(ts, losses)

    def update_with_all_losses(self, ts, losses):
        raise NotImplementedError


class LossSecondMomentResampler(LossAwareSampler):
    def __init__(self, diffusion, history_per_term=10, uniform_prob=0.001):
        self.num_timesteps = diffusion.num_timesteps
        self.history_per_term = history_per_term
        self.uniform_prob = uniform_prob
        self._loss_history = np.zeros([self.num_timesteps, history_per_term], dtype=np.float64)
        self._loss_counts = np.zeros([self.num_timesteps], dtype=np.int64)

    def weights(self):
        if not self._warmed_up():
            return np.ones([self.num_timesteps], dtype=np.float64)
        w = np.sqrt(np.mean(self._loss_history ** 2, axis=-1))
        w /= np.sum(w)
        w *= 1 - self.uniform_prob
        w += self.uniform_prob / len(w)
        return w

    def update_with_all_losses(self, ts, losses):
        for t, loss in zip(ts, losses):
            if self._loss_counts[t] == self.history_per_term:
                self._loss_history[t, :-1] = self._loss_history[t, 1:]
                self._loss_history[t, -1] = loss
            else:
                self._loss_history[t, self._loss_counts[t]] = loss
                self._loss_counts[t] += 1

    def _warmed_up(self):
        return (self._loss_counts == self.history_per_term).all()
