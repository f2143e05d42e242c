"""Normalization primitives (counterpart of the reference ``ops/norms.py``).

Plain tensor code; statistics are computed in fp32 whatever the input dtype.
The epsilons are the reference's 1e-6, not torch's 1e-5 defaults.
"""

from __future__ import annotations

import torch


def rms_norm(x, weight=None, eps=1e-6):
    """RMSNorm over the last axis. weight=None ~ elementwise_affine=False."""
    dtype = x.dtype
    xf = x.float()
    y = xf * torch.rsqrt(torch.mean(xf * xf, dim=-1, keepdim=True) + eps)
    y = y.to(dtype)
    if weight is not None:
        y = y * weight.to(dtype)
    return y


def layer_norm(x, scale=None, bias=None, eps=1e-6):
    """LayerNorm over the last axis (biased variance)."""
    dtype = x.dtype
    xf = x.float()
    mean = torch.mean(xf, dim=-1, keepdim=True)
    var = torch.mean(torch.square(xf - mean), dim=-1, keepdim=True)
    y = ((xf - mean) * torch.rsqrt(var + eps)).to(dtype)
    if scale is not None:
        y = y * scale.to(dtype)
    if bias is not None:
        y = y + bias.to(dtype)
    return y


def group_norm(x, scale, bias, num_groups=32, eps=1e-6):
    """GroupNorm for NHWC feature maps [B, H, W, C]: statistics per
    (batch, group) over H, W and the group's channels."""
    b, h, w, c = x.shape
    dtype = x.dtype
    xf = x.float().reshape(b, h, w, num_groups, c // num_groups)
    mean = torch.mean(xf, dim=(1, 2, 4), keepdim=True)
    var = torch.mean(torch.square(xf - mean), dim=(1, 2, 4), keepdim=True)
    y = ((xf - mean) * torch.rsqrt(var + eps)).reshape(b, h, w, c).to(dtype)
    return y * scale.to(dtype) + bias.to(dtype)
