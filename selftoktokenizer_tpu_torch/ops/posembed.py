"""Sine/cosine positional embeddings and timestep frequency embeddings
(counterpart of the reference ``ops/posembed.py``).

Tables are computed in float64 numpy at model-build time, exactly as the
reference does, and stored as fp32 buffers.
"""

from __future__ import annotations

import math

import numpy as np
import torch


def sincos_1d(embed_dim: int, pos: np.ndarray) -> np.ndarray:
    """[sin | cos] 1-D table."""
    assert embed_dim % 2 == 0
    omega = np.arange(embed_dim // 2, dtype=np.float64)
    omega /= embed_dim / 2.0
    omega = 1.0 / 10000 ** omega
    pos = np.asarray(pos, dtype=np.float64).reshape(-1)
    out = np.einsum("m,d->md", pos, omega)
    return np.concatenate([np.sin(out), np.cos(out)], axis=1)


def sincos_2d(embed_dim: int, grid_size: int, scaling_factor=None, offset=None) -> np.ndarray:
    """2-D sincos table, row-major over (h, w)."""
    grid_h = np.arange(grid_size, dtype=np.float32)
    grid_w = np.arange(grid_size, dtype=np.float32)
    grid = np.stack(np.meshgrid(grid_w, grid_h), axis=0)  # w first
    if scaling_factor is not None:
        grid = grid / scaling_factor
    if offset is not None:
        grid = grid - offset
    emb_h = sincos_1d(embed_dim // 2, grid[0])
    emb_w = sincos_1d(embed_dim // 2, grid[1])
    return np.concatenate([emb_h, emb_w], axis=1)  # (grid*grid, D)


def timestep_embedding(t, dim: int, max_period: int = 10000):
    """Sinusoidal timestep embedding, [cos | sin] ordering.

    t: [...] float or int tensor; returns [..., dim] float32.
    """
    half = dim // 2
    freqs = torch.exp(
        -math.log(max_period)
        * torch.arange(half, dtype=torch.float32, device=t.device) / half)
    args = t.to(torch.float32)[..., None] * freqs
    emb = torch.cat([torch.cos(args), torch.sin(args)], dim=-1)
    if dim % 2:
        emb = torch.cat([emb, torch.zeros_like(emb[..., :1])], dim=-1)
    return emb


def crop_pos_embed(pos_embed, max_size: int, h: int, w: int):
    """Center-crop a (1, max*max, C) table to (1, h*w, C); h/w are
    patch-grid sizes."""
    c = pos_embed.shape[-1]
    top = (max_size - h) // 2
    left = (max_size - w) // 2
    grid = pos_embed.reshape(1, max_size, max_size, c)
    return grid[:, top:top + h, left:left + w, :].reshape(1, h * w, c)
