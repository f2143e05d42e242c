"""Scaled dot-product attention (counterpart of the reference
``ops/attention.py``).

``sdpa``, ``sdpa_key_mask``, ``sdpa_bf16_scores`` and ``mha`` are plain
tensor code. ``serving_attention`` is the router to the CUDA kernel of
``ops/flash_attention.py``.

Mask semantics: boolean mask True = attend; a float mask is an additive
bias. Softmax statistics in fp32.
"""

from __future__ import annotations

import math
from typing import Optional

import torch

from selftoktokenizer_tpu_torch.ops import flash_attention as fa
from selftoktokenizer_tpu_torch.ops import routing


def sdpa(q, k, v, mask=None, scale: Optional[float] = None):
    """q,k,v: [B, H, L, D] (mask broadcastable to [B, H, Lq, Lk])."""
    d = q.shape[-1]
    scale = scale if scale is not None else 1.0 / math.sqrt(d)
    logits = torch.matmul(q, k.transpose(-1, -2)).float() * scale
    if mask is not None:
        if mask.dtype == torch.bool:
            logits = logits.masked_fill(~mask, float("-inf"))
        else:
            logits = logits + mask.to(logits.dtype)
    w = torch.softmax(logits, dim=-1).to(q.dtype)
    return torch.matmul(w, v)


def sdpa_bf16_scores(q, k, v, scale: Optional[float] = None, key_mask=None):
    """SDPA that keeps the score matrix in the input type (bf16 on the
    serving tier): max-subtract on those scores, exp and sum in fp32, P V
    accumulated in fp32, normalisation after the P V product."""
    d = q.shape[-1]
    scale = scale if scale is not None else 1.0 / math.sqrt(d)
    logits = torch.matmul(q, k.transpose(-1, -2)) * torch.tensor(
        scale, dtype=q.dtype, device=q.device)
    if key_mask is not None:
        logits = logits + torch.where(key_mask, 0.0, -1e30).to(q.dtype)[:, None, None, :]
    m = torch.amax(logits, dim=-1, keepdim=True)
    e = torch.exp((logits - m).float()).to(q.dtype)
    o = torch.matmul(e.float(), v.float())
    denom = torch.sum(e.float(), dim=-1, keepdim=True)
    return (o / denom).to(q.dtype)


def sdpa_key_mask(q, k, v, key_mask=None, scale: Optional[float] = None):
    """SDPA where the mask is per-key only: key_mask [B, Lk] bool.

    The bias is a finite -1e30 (not -inf), the kernel's convention: a fully
    masked row then yields the uniform mean here and there."""
    if key_mask is None:
        return sdpa(q, k, v, scale=scale)
    bias = torch.where(key_mask, 0.0, -1e30).to(torch.float32)
    return sdpa(q, k, v, mask=bias[:, None, None, :], scale=scale)


def serving_attention(q, k, v, key_mask=None):
    """Attention of the serving paths (bf16 encode trunk, diffusion decode).

    Every call with head dim 64 or 128 goes to the kernel wrapper
    ``flash_sdpa_key_mask`` whatever the key length; other head dims stay
    plain tensor code. ``routing.kernel_route("plain")`` swaps the wrapper
    for the kernel's plain version."""
    if fa.supported(q, k):
        if routing.current() == "plain":
            return fa.flash_sdpa_key_mask_plain(q, k, v, key_mask)
        return fa.flash_sdpa_key_mask(q, k, v, key_mask)
    return sdpa_key_mask(q, k, v, key_mask)


def mha(q, k, v, heads: int, mask=None):
    """Multi-head attention on flat [B, L, H*D] tensors."""
    b, lq, c = q.shape
    d = c // heads

    def split(t):
        return t.reshape(b, t.shape[1], heads, d).permute(0, 2, 1, 3)

    out = sdpa(split(q), split(k), split(v), mask=mask)
    return out.permute(0, 2, 1, 3).reshape(b, lq, c)
