"""DiTi: diffusion-timestep -> token-index maps (counterpart of the
reference ``models/diti.py``).

The token order of a Selftok sequence mirrors the reverse-diffusion timestep
order; DiTi maps a timestep t in [0, 1000] to the number of active tokens
k in [0, K). ``DiTi`` is a discrete lookup table built from stage
boundaries, ``DiTiCont`` the piecewise-linear continuous map the shipped
eval configs use, ``DiTiNormal`` a logit-normal CDF map. ``to_indices``
takes and returns tensors.
"""

from __future__ import annotations

import math

import numpy as np
import torch


def _parse_int_list(spec):
    """Parse '200,400,600' -> [200, 400, 600]; pass lists through; '' -> None."""
    if spec is None:
        return None
    if isinstance(spec, str):
        if not spec:
            return None
        return [int(x) for x in spec.split(",")]
    return [int(x) for x in spec]


class DiTi:
    """Discrete-table timestep->index map."""

    def __init__(self, n_timesteps, K, stages, k_per_stage):
        k_per_stage = _parse_int_list(k_per_stage)
        stages = _parse_int_list(stages)
        self.stages = stages
        self.k_per_stage = k_per_stage
        self.K = K

        t_to_idx = np.zeros(n_timesteps, dtype=np.int64)
        idx_to_max_t = np.zeros(K, dtype=np.int64)
        if k_per_stage:
            assert stages is not None
            current_stage = 0
            sum_indices = 0
            for t in range(n_timesteps):
                if t == stages[current_stage]:
                    sum_indices += k_per_stage[current_stage]
                    current_stage += 1
                current_steps = float(stages[current_stage])
                if current_stage > 0:
                    current_steps -= stages[current_stage - 1]
                current_k = float(k_per_stage[current_stage])
                t_adj = t - stages[current_stage - 1] if current_stage > 0 else t
                idx = int(float(t_adj) / current_steps * current_k + sum_indices)
                t_to_idx[t] = idx
                idx_to_max_t[idx] = t
        else:
            for t in range(n_timesteps):
                idx = int(float(t) / (float(n_timesteps) / K))
                t_to_idx[t] = idx
                idx_to_max_t[idx] = t
        self._t_to_idx = torch.from_numpy(t_to_idx)
        self._idx_to_max_t = idx_to_max_t

    def get_key_timesteps(self):
        return [0] + list(self._idx_to_max_t)

    def get_timestep_range(self, k):
        key = self.get_key_timesteps()
        return key[k], key[k + 1]

    def get_position(self, k):
        return 1000 + (k * 8)

    def to_indices(self, t):
        t = torch.as_tensor(t)
        ti = torch.clamp(torch.floor(t.double()).long(), 0, 999)
        idx = self._t_to_idx.to(ti.device)[ti]
        return torch.clamp(idx, 0, self.K - 1).to(torch.int32)


class DiTiCont:
    """Piecewise-linear continuous timestep->index map. The segments are
    applied in order and later segments overwrite earlier ones wherever
    ``t >= low``."""

    def __init__(self, n_timesteps, K, stages, k_per_stage):
        self.K = K
        k_per_stage = _parse_int_list(k_per_stage)
        stages = _parse_int_list(stages)
        assert k_per_stage and stages
        self.k_per_stage = k_per_stage
        self.stages = [0] + stages
        # (low, slope, base) per segment
        self.segments = []
        acc = 0
        for i in range(len(stages)):
            lo, hi = self.stages[i], self.stages[i + 1]
            self.segments.append((float(lo), float(k_per_stage[i]) / (hi - lo), float(acc)))
            acc += k_per_stage[i]

    def to_indices(self, t):
        t = torch.as_tensor(t).to(torch.float32)
        ind = torch.zeros_like(t)
        for low, slope, base in self.segments:
            ind = torch.where(t - low >= 0, slope * (t - low) + base, ind)
        return torch.clamp(ind.to(torch.int32), 0, self.K - 1)

    def get_position(self, k):
        return 1000 + (k * 8)


class DiTiNormal:
    """Logit-normal CDF timestep->index map: t in (0, 1);
    index = ceil(K * Phi((logit(t) - m) / s))."""

    def __init__(self, n_timesteps, K, m=0.0, s=1.0):
        self.K = K
        self.m = m
        self.s = s
        self.stages = None  # sentinel used by samplers to pick the 0-1 t scale

    def get_cdf(self, t):
        z = torch.log(t / (1 - t))
        return 0.5 * (1 + torch.erf((z - self.m) / (self.s * math.sqrt(2.0))))

    def to_indices(self, t):
        t = torch.as_tensor(t).to(torch.float32)
        ind = torch.ceil(self.get_cdf(t) * self.K)
        return torch.clamp(ind.to(torch.int32), 0, self.K - 1)

    def get_position(self, k):
        return 1000 + (k * 8)


def make_diti(k, stages=None, k_per_stage=None, k_m=None, k_s=None, n_timesteps=1000):
    """Continuous piecewise map when stage boundaries are given, logit-normal
    otherwise."""
    if stages is not None:
        return DiTiCont(n_timesteps, k, stages, k_per_stage)
    return DiTiNormal(n_timesteps, k, k_m, k_s)
