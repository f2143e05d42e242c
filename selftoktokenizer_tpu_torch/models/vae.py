"""SD3 VAE (16-channel, 8x downsample), forward only (counterpart of the
reference ``models/vae.py``).

Public functions take and return NHWC feature maps, as the reference does;
``ops.linear.conv2d`` permutes to NCHW for the conv itself. GroupNorm
statistics fp32 (32 groups, eps 1e-6); the mid-block attention is single
head with head dim = channels (512 at the default width), which the
attention kernel never takes, so it is plain ``sdpa``. Module names follow
the bundled SDVAE checkpoint (``encoder.down.0.block.0.conv1.weight`` ...).
"""

from __future__ import annotations

import dataclasses

import torch
import torch.nn.functional as F
from torch import nn

from selftoktokenizer_tpu_torch.ops.attention import sdpa
from selftoktokenizer_tpu_torch.ops.linear import conv2d
from selftoktokenizer_tpu_torch.ops.norms import group_norm


@dataclasses.dataclass
class VAEConfig:
    ch: int = 128
    ch_mult: tuple = (1, 2, 4, 4)
    num_res_blocks: int = 2
    in_channels: int = 3
    out_ch: int = 3
    z_channels: int = 16

    @property
    def num_resolutions(self):
        return len(self.ch_mult)


class SD3LatentFormat:
    scale_factor = 1.5305
    shift_factor = 0.0609

    @classmethod
    def process_in(cls, latent):
        return (latent - cls.shift_factor) * cls.scale_factor

    @classmethod
    def process_out(cls, latent):
        return (latent / cls.scale_factor) + cls.shift_factor


# ---------------------------------------------------------------------------
# weight-owning modules
# ---------------------------------------------------------------------------

class _Norm(nn.Module):
    def __init__(self, c):
        super().__init__()
        self.weight = nn.Parameter(torch.ones(c))
        self.bias = nn.Parameter(torch.zeros(c))


class ResnetBlock(nn.Module):
    def __init__(self, c_in, c_out):
        super().__init__()
        self.norm1 = _Norm(c_in)
        self.conv1 = nn.Conv2d(c_in, c_out, 3, padding=1)
        self.norm2 = _Norm(c_out)
        self.conv2 = nn.Conv2d(c_out, c_out, 3, padding=1)
        self.nin_shortcut = nn.Conv2d(c_in, c_out, 1) if c_in != c_out else None


class AttnBlock(nn.Module):
    def __init__(self, c):
        super().__init__()
        self.norm = _Norm(c)
        self.q = nn.Conv2d(c, c, 1)
        self.k = nn.Conv2d(c, c, 1)
        self.v = nn.Conv2d(c, c, 1)
        self.proj_out = nn.Conv2d(c, c, 1)


class _Resample(nn.Module):
    def __init__(self, c):
        super().__init__()
        self.conv = nn.Conv2d(c, c, 3)


class _Level(nn.Module):
    def __init__(self, blocks, resample_name=None, resample_ch=None):
        super().__init__()
        self.block = nn.ModuleList(blocks)
        if resample_name is not None:
            setattr(self, resample_name, _Resample(resample_ch))


class _Mid(nn.Module):
    def __init__(self, c):
        super().__init__()
        self.block_1 = ResnetBlock(c, c)
        self.attn_1 = AttnBlock(c)
        self.block_2 = ResnetBlock(c, c)


class VAEEncoder(nn.Module):
    def __init__(self, cfg: VAEConfig):
        super().__init__()
        self.conv_in = nn.Conv2d(cfg.in_channels, cfg.ch, 3, padding=1)
        in_mult = (1,) + tuple(cfg.ch_mult)
        levels = []
        block_in = cfg.ch
        for i_level in range(cfg.num_resolutions):
            block_in = cfg.ch * in_mult[i_level]
            block_out = cfg.ch * cfg.ch_mult[i_level]
            blocks = []
            for _ in range(cfg.num_res_blocks):
                blocks.append(ResnetBlock(block_in, block_out))
                block_in = block_out
            last = i_level == cfg.num_resolutions - 1
            levels.append(_Level(blocks, None if last else "downsample", block_in))
        self.down = nn.ModuleList(levels)
        self.mid = _Mid(block_in)
        self.norm_out = _Norm(block_in)
        self.conv_out = nn.Conv2d(block_in, 2 * cfg.z_channels, 3, padding=1)


class VAEDecoder(nn.Module):
    def __init__(self, cfg: VAEConfig):
        super().__init__()
        block_in = cfg.ch * cfg.ch_mult[-1]
        self.conv_in = nn.Conv2d(cfg.z_channels, block_in, 3, padding=1)
        self.mid = _Mid(block_in)
        levels = [None] * cfg.num_resolutions
        for i_level in reversed(range(cfg.num_resolutions)):
            block_out = cfg.ch * cfg.ch_mult[i_level]
            blocks = []
            for _ in range(cfg.num_res_blocks + 1):
                blocks.append(ResnetBlock(block_in, block_out))
                block_in = block_out
            levels[i_level] = _Level(blocks, None if i_level == 0 else "upsample",
                                     block_in)
        self.up = nn.ModuleList(levels)
        self.norm_out = _Norm(block_in)
        self.conv_out = nn.Conv2d(block_in, cfg.out_ch, 3, padding=1)


class SDVAE(nn.Module):
    def __init__(self, cfg: VAEConfig = None):
        super().__init__()
        self.cfg = cfg or VAEConfig()
        self.encoder = VAEEncoder(self.cfg)
        self.decoder = VAEDecoder(self.cfg)


def vae_from_state_dict(sd) -> SDVAE:
    """An SD3 VAE state dict (``encoder.*`` and ``decoder.*``, the
    ``first_stage_model.`` prefix already taken off) -> SDVAE on the CPU,
    fp32, loaded strictly. The width comes from ``encoder.conv_in``; keys
    outside the two halves are not read."""
    sd = {k: v.float() for k, v in sd.items() if k.startswith(("encoder.", "decoder."))}
    with torch.device("meta"):
        vae = SDVAE(VAEConfig(ch=sd["encoder.conv_in.weight"].shape[0]))
    vae.load_state_dict(sd, strict=True, assign=True)
    return vae


# ---------------------------------------------------------------------------
# forward
# ---------------------------------------------------------------------------

def _conv(m, x, **kw):
    return conv2d(x, m.weight, m.bias, **kw)


def _gn(m, x):
    return group_norm(x, m.weight, m.bias)


def resnet_block(p: ResnetBlock, x):
    h = _conv(p.conv1, F.silu(_gn(p.norm1, x)))
    h = _conv(p.conv2, F.silu(_gn(p.norm2, h)))
    if p.nin_shortcut is not None:
        x = _conv(p.nin_shortcut, x)
    return x + h


def attn_block(p: AttnBlock, x):
    """Single-head attention over the spatial grid."""
    b, h, w, c = x.shape
    hidden = _gn(p.norm, x)
    q = _conv(p.q, hidden).reshape(b, 1, h * w, c)
    k = _conv(p.k, hidden).reshape(b, 1, h * w, c)
    v = _conv(p.v, hidden).reshape(b, 1, h * w, c)
    out = sdpa(q, k, v).reshape(b, h, w, c)
    return x + _conv(p.proj_out, out)


def downsample(p, x):
    """Asymmetric (0,1,0,1) pad + stride-2 valid conv."""
    x = F.pad(x, (0, 0, 0, 1, 0, 1))   # NHWC: pad W and H at the far side
    return _conv(p.conv, x, stride=2, padding="VALID")


def upsample(p, x):
    """Nearest 2x + conv3x3."""
    x = x.repeat_interleave(2, dim=1).repeat_interleave(2, dim=2)
    return _conv(p.conv, x)


def vae_encoder_apply(p: VAEEncoder, cfg: VAEConfig, x):
    """x: NHWC [B,H,W,3] -> moments [B,H/8,W/8,2*z]."""
    h = _conv(p.conv_in, x)
    for i_level in range(cfg.num_resolutions):
        for i_block in range(cfg.num_res_blocks):
            h = resnet_block(p.down[i_level].block[i_block], h)
        if i_level != cfg.num_resolutions - 1:
            h = downsample(p.down[i_level].downsample, h)
    h = resnet_block(p.mid.block_1, h)
    h = attn_block(p.mid.attn_1, h)
    h = resnet_block(p.mid.block_2, h)
    h = F.silu(_gn(p.norm_out, h))
    return _conv(p.conv_out, h)


def vae_decoder_apply(p: VAEDecoder, cfg: VAEConfig, z):
    """z: NHWC latents -> image."""
    h = _conv(p.conv_in, z)
    h = resnet_block(p.mid.block_1, h)
    h = attn_block(p.mid.attn_1, h)
    h = resnet_block(p.mid.block_2, h)
    for i_level in reversed(range(cfg.num_resolutions)):
        for i_block in range(cfg.num_res_blocks + 1):
            h = resnet_block(p.up[i_level].block[i_block], h)
        if i_level != 0:
            h = upsample(p.up[i_level].upsample, h)
    h = F.silu(_gn(p.norm_out, h))
    return _conv(p.conv_out, h)


def vae_encode_moments(p: SDVAE, cfg: VAEConfig, x):
    mom = vae_encoder_apply(p.encoder, cfg, x)
    mean, logvar = torch.chunk(mom, 2, dim=-1)
    return mean, torch.clamp(logvar, -30.0, 20.0)


def vae_encode_mode(p: SDVAE, cfg: VAEConfig, x):
    """Deterministic encode (the distribution's mode), the pipeline's choice."""
    mean, _ = vae_encode_moments(p, cfg, x)
    return mean


def vae_decode(p: SDVAE, cfg: VAEConfig, z):
    return vae_decoder_apply(p.decoder, cfg, z)
