"""The SD3 VAE (16 latent channels, 8x down): the encoder's mean and the
decoder, over a state dict with the bundled SDVAE checkpoint's names
(``encoder.down.0.block.0.conv1.weight`` ...). It computes in the type of
its input; the configuration states the VAE's type (``vae.dtype``)."""

from __future__ import annotations

import torch
import torch.nn.functional as F

from benchmark.reference.nn import attention, conv2d, group_norm

SCALE, SHIFT = 1.5305, 0.0609     # SD3's latent format
FP8_MAX = 448.0                   # the largest finite float8 e4m3


def fp8(t):
    """``t`` rounded to float8 e4m3 at one scale for the tensor (its largest
    magnitude to ``FP8_MAX``), back in t's type."""
    s = t.detach().abs().amax().float().clamp_min(1e-30) / FP8_MAX
    return ((t.float() / s).to(torch.float8_e4m3fn).float() * s).to(t.dtype)


def fp8_conv2d(x, sd, name, **kw):
    """``conv2d`` with both operands rounded to float8 e4m3, products summed
    in x's type: the convolution of an fp8 VAE."""
    w = fp8(sd[name + ".weight"].to(x.dtype))
    return conv2d(fp8(x), {name + ".weight": w, name + ".bias": sd[name + ".bias"]}, name, **kw)


def _resnet(sd, name, x, conv=conv2d):
    h = conv(F.silu(group_norm(x, sd[name + ".norm1.weight"], sd[name + ".norm1.bias"])),
             sd, name + ".conv1")
    h = conv(F.silu(group_norm(h, sd[name + ".norm2.weight"], sd[name + ".norm2.bias"])),
             sd, name + ".conv2")
    if name + ".nin_shortcut.weight" in sd:
        x = conv(x, sd, name + ".nin_shortcut")
    return x + h


def _attn(sd, name, x, conv=conv2d):
    b, h, w, c = x.shape
    n = group_norm(x, sd[name + ".norm.weight"], sd[name + ".norm.bias"])
    q, k, v = (conv(n, sd, f"{name}.{p}").reshape(b, 1, h * w, c) for p in "qkv")
    out = attention(q, k, v).reshape(b, h, w, c)
    return x + conv(out, sd, name + ".proj_out")


def _mid(sd, name, x, conv=conv2d):
    x = _resnet(sd, name + ".block_1", x, conv)
    x = _attn(sd, name + ".attn_1", x, conv)
    return _resnet(sd, name + ".block_2", x, conv)


def _levels(sd, prefix):
    return 1 + max(int(k.split(".")[2]) for k in sd if k.startswith(prefix + "."))


def _blocks(sd, prefix):
    return 1 + max(int(k.split(".")[4]) for k in sd if k.startswith(prefix + ".0.block."))


def encode_mean(sd, images):
    """images NHWC [-1, 1] -> the latent distribution's mean, NHWC [B, H/8, W/8, 16]."""
    h = conv2d(images, sd, "encoder.conv_in")
    n_levels, n_blocks = _levels(sd, "encoder.down"), _blocks(sd, "encoder.down")
    for i in range(n_levels):
        for j in range(n_blocks):
            h = _resnet(sd, f"encoder.down.{i}.block.{j}", h)
        if i != n_levels - 1:
            h = F.pad(h, (0, 0, 0, 1, 0, 1))
            h = conv2d(h, sd, f"encoder.down.{i}.downsample.conv", stride=2, padding=0)
    h = _mid(sd, "encoder.mid", h)
    h = F.silu(group_norm(h, sd["encoder.norm_out.weight"], sd["encoder.norm_out.bias"]))
    moments = conv2d(h, sd, "encoder.conv_out")
    return moments[..., :moments.shape[-1] // 2]


def decode(sd, z, conv=conv2d):
    """Latents NHWC -> image NHWC, unclamped; ``conv`` computes every
    convolution."""
    h = conv(z, sd, "decoder.conv_in")
    h = _mid(sd, "decoder.mid", h, conv)
    n_levels, n_blocks = _levels(sd, "decoder.up"), _blocks(sd, "decoder.up")
    for i in reversed(range(n_levels)):
        for j in range(n_blocks):
            h = _resnet(sd, f"decoder.up.{i}.block.{j}", h, conv)
        if i != 0:
            h = h.repeat_interleave(2, dim=1).repeat_interleave(2, dim=2)
            h = conv(h, sd, f"decoder.up.{i}.upsample.conv")
    h = F.silu(group_norm(h, sd["decoder.norm_out.weight"], sd["decoder.norm_out.bias"]))
    return conv(h, sd, "decoder.conv_out")


def images_to_latents(sd, images, dtype):
    """The tokenizer's fp32 input: the VAE mean, in ``dtype``, in SD3's
    latent format."""
    return ((encode_mean(sd, images.to(dtype)) - SHIFT) * SCALE).float()


def latents_to_images(sd, latents, dtype, fp8_convs=False):
    """The tokenizer's fp32 latents -> images in [0, 1], the VAE in ``dtype``
    (with ``fp8_convs``, every convolution's operands rounded to float8)."""
    img = decode(sd, (latents / SCALE + SHIFT).to(dtype), fp8_conv2d if fp8_convs else conv2d)
    return (torch.clamp(img.float(), -1.0, 1.0) + 1.0) / 2.0
