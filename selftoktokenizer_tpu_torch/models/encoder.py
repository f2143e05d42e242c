"""Selftok dual-stream Qformer encoder (counterpart of the reference
``models/encoder.py:46-641``, mode ``dual``, unidirectional).

The modules own the weights under the reference checkpoint's names
(``blocks.{i}.attn.qkv.weight``, ``blocks.{i}.adaLN_modulation.1.weight``,
``x_embedder.proj.weight`` ...); the ``*_apply`` functions, named as in the
reference, do the work. Feature maps are NHWC.

Not ported yet (each raises NotImplementedError naming its ROADMAP.md queue
item): the bidirectional, zero-init, concat, qformer and vit encoder modes
and ``attn_mask``.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from selftoktokenizer_tpu_torch.models import vq as vq_mod
from selftoktokenizer_tpu_torch.ops.attention import sdpa, serving_attention
from selftoktokenizer_tpu_torch.ops.linear import (
    gate, linear, mlp, modulate, patch_embed, timestep_embedder)
from selftoktokenizer_tpu_torch.ops.norms import layer_norm, rms_norm
from selftoktokenizer_tpu_torch.ops.posembed import crop_pos_embed, sincos_2d

_LATER_MODES = ("ROADMAP.md queue item 'remaining encoder modes / multires / "
                "DiT / DDPM / text encoders'")


@dataclasses.dataclass
class EncoderConfig:
    K: int
    input_size: int = 32
    encoder_hidden_size: int = 256
    patch_size: int = 8
    in_channels: int = 4
    hidden_size: int = 256
    depth: Optional[int] = None
    num_heads: int = 4
    mlp_ratio: float = 4.0
    pre_norm: bool = False
    post_norm: bool = True
    qformer_mode: str = "dual"          # 'dual' | 'concat' | 'qformer' | 'vit'
    pos_embed_max_size: Optional[int] = None
    query_dim: Optional[int] = None
    query_heads: Optional[int] = None
    bidirectional: bool = False
    zero_init: bool = False
    time_adaln: bool = False
    qk_norm: bool = False
    attn_mask: bool = False
    single_token: bool = False
    post_ln: bool = False
    gradient_checkpointing: bool = False
    # True: adaLN positions are diti.get_position(k) = 1000 + 8k;
    # False: plain arange(K)
    diti_positions: bool = True
    # quantizer
    code_dim: int = 16
    codebook_size: int = 32768
    # multi-resolution stream (not ported; kept so configs compare equal)
    low_res_hidden_size: int = 64
    low_res_code_dim: int = 16
    low_res_codebook_size: int = 32768
    low_res_K: int = 512
    low_res_heads: int = 8
    reuse_token_embeds: bool = True

    def __post_init__(self):
        if self.depth is None:
            self.depth = self.K
        if self.query_dim is None:
            self.query_dim = self.hidden_size
        if self.query_heads is None:
            self.query_heads = self.num_heads

    @property
    def encoder_out_dim(self):
        return self.query_dim if self.qformer_mode != "vit" else self.hidden_size

    @property
    def ln_scale(self):
        return 1.97 if self.post_ln else 1.0


# ---------------------------------------------------------------------------
# weight-owning modules (reference checkpoint names)
# ---------------------------------------------------------------------------

class Mlp(nn.Module):
    def __init__(self, d_in, d_hidden, d_out=None):
        super().__init__()
        self.fc1 = nn.Linear(d_in, d_hidden)
        self.fc2 = nn.Linear(d_hidden, d_out or d_in)


def mlp_apply(m: Mlp, x):
    return mlp(x, m.fc1.weight, m.fc1.bias, m.fc2.weight, m.fc2.bias)


class TimestepEmbedder(nn.Module):
    def __init__(self, hidden, dim_freq=256):
        super().__init__()
        self.mlp = nn.Sequential(nn.Linear(dim_freq, hidden), nn.SiLU(),
                                 nn.Linear(hidden, hidden))
        self.dim_freq = dim_freq


def timestep_embedder_apply(m: TimestepEmbedder, t):
    return timestep_embedder(t, m.mlp[0].weight, m.mlp[0].bias,
                             m.mlp[2].weight, m.mlp[2].bias, m.dim_freq)


class RMSNormWeight(nn.Module):
    def __init__(self, dim):
        super().__init__()
        self.weight = nn.Parameter(torch.ones(dim))


class PatchEmbed(nn.Module):
    """The reference's strided-conv patch embedding; ``ops.linear.patch_embed``
    applies its kernel as one matmul."""

    def __init__(self, patch, c_in, d):
        super().__init__()
        self.proj = nn.Conv2d(c_in, d, kernel_size=patch, stride=patch)
        self.patch = patch


def patch_embed_apply(m: PatchEmbed, x):
    return patch_embed(x, m.proj.weight, m.proj.bias, m.patch)


class DualAttention(nn.Module):
    def __init__(self, cfg: EncoderConfig):
        super().__init__()
        C, Cq = cfg.hidden_size, cfg.query_dim
        self.qkv = nn.Linear(C, 3 * C)
        self.query_linear = nn.Linear(Cq, 3 * Cq)
        self.proj = nn.Linear(C, C)
        self.query_proj = nn.Linear(Cq, Cq)
        self.to_query_kv = nn.Linear(C, 2 * Cq)
        if cfg.qk_norm:
            self.q_norm = RMSNormWeight(C // cfg.num_heads)
            self.k_norm = RMSNormWeight(C // cfg.num_heads)
            self.query_qnorm = RMSNormWeight(Cq // cfg.query_heads)
            self.query_knorm = RMSNormWeight(Cq // cfg.query_heads)


class DualBlock(nn.Module):
    def __init__(self, cfg: EncoderConfig):
        super().__init__()
        self.attn = DualAttention(cfg)
        self.mlp = Mlp(cfg.hidden_size, int(cfg.hidden_size * cfg.mlp_ratio))
        self.q_mlp = Mlp(cfg.query_dim, int(cfg.query_dim * cfg.mlp_ratio))
        if cfg.time_adaln:
            self.adaLN_modulation = nn.Sequential(
                nn.SiLU(), nn.Linear(cfg.query_dim, 6 * cfg.query_dim))
            self.t_embedder = TimestepEmbedder(cfg.query_dim)
        else:
            self.adaLN_modulation = None


class LayerNormWeight(nn.Module):
    def __init__(self, dim):
        super().__init__()
        self.weight = nn.Parameter(torch.ones(dim))
        self.bias = nn.Parameter(torch.zeros(dim))


class QformerEncoder(nn.Module):
    """Weights of the dual-stream encoder and its quantizer."""

    def __init__(self, cfg: EncoderConfig):
        super().__init__()
        _check_supported(cfg)
        self.cfg = cfg
        max_sz = cfg.pos_embed_max_size
        grid = max_sz if max_sz else cfg.input_size // cfg.patch_size
        self.x_embedder = PatchEmbed(cfg.patch_size, cfg.in_channels, cfg.hidden_size)
        self.register_buffer("pos_embed", torch.from_numpy(
            sincos_2d(cfg.hidden_size, grid)).float()[None])
        self.final_layer_norm = LayerNormWeight(cfg.encoder_out_dim)
        self.final_layer_norm2 = LayerNormWeight(cfg.code_dim)
        self.final_layer_norm3 = LayerNormWeight(cfg.encoder_hidden_size)
        self.quantizer = vq_mod.VectorQuantize(
            latent_dim=cfg.encoder_out_dim, code_dim=cfg.code_dim,
            codebook_size=cfg.codebook_size, output_dim=cfg.encoder_hidden_size)
        self.query_tokens = nn.Parameter(torch.empty(1, cfg.K, cfg.query_dim))
        self.blocks = nn.ModuleList(DualBlock(cfg) for _ in range(cfg.depth))


def _check_supported(cfg: EncoderConfig):
    if cfg.qformer_mode != "dual":
        raise NotImplementedError(
            f"encoder mode {cfg.qformer_mode!r} is not ported yet: {_LATER_MODES}")
    if cfg.bidirectional or cfg.zero_init:
        raise NotImplementedError(
            f"bidirectional / zero-init dual attention is not ported yet: {_LATER_MODES}")
    if cfg.attn_mask:
        raise NotImplementedError(
            f"encoder attn_mask is not ported yet: {_LATER_MODES}")


# ---------------------------------------------------------------------------
# DualAttention / DualBlock
# ---------------------------------------------------------------------------

def _merge_heads(t):
    b, h, n, d = t.shape
    return t.permute(0, 2, 1, 3).reshape(b, n, h * d)


def dual_attention_apply(p: DualAttention, cfg: EncoderConfig, x, query,
                         fast_attn=False):
    """Two-stream attention, unidirectional: x [B,N,C] self-attends; query
    [B,K,Cq] attends to [x-derived KV || query KV], image keys first.

    fast_attn routes the query attention through ``serving_attention`` (the
    CUDA kernel); otherwise both attentions are plain fp32-softmax sdpa. The
    x-stream self-attention (head dim 16 at the flagship) is always plain.
    """
    B, N, C = x.shape
    _, K, Cq = query.shape
    H, QH = cfg.num_heads, cfg.query_heads

    xqkv = linear(x, p.qkv.weight, p.qkv.bias).reshape(
        B, N, 3, H, C // H).permute(2, 0, 3, 1, 4)
    xq, xk, xv = xqkv[0], xqkv[1], xqkv[2]
    if cfg.qk_norm:
        xq = rms_norm(xq, p.q_norm.weight)
        xk = rms_norm(xk, p.k_norm.weight)

    qqkv = linear(query, p.query_linear.weight, p.query_linear.bias).reshape(
        B, K, 3, QH, Cq // QH).permute(2, 0, 3, 1, 4)
    qq, qk, qv = qqkv[0], qqkv[1], qqkv[2]

    kv = linear(x, p.to_query_kv.weight, p.to_query_kv.bias).reshape(
        B, N, 2, QH, Cq // QH).permute(2, 0, 3, 1, 4)
    x_out = sdpa(xq, xk, xv)
    k2 = torch.cat([kv[0], qk], dim=2)
    v2 = torch.cat([kv[1], qv], dim=2)
    if cfg.qk_norm:
        qq = rms_norm(qq, p.query_qnorm.weight)
        k2 = rms_norm(k2, p.query_knorm.weight)
    if fast_attn:
        q_out = serving_attention(qq, k2, v2)
    else:
        q_out = sdpa(qq, k2, v2)

    x_out = linear(_merge_heads(x_out), p.proj.weight, p.proj.bias)
    q_out = linear(_merge_heads(q_out), p.query_proj.weight, p.query_proj.bias)
    return x_out, q_out


def dual_block_mods(p: DualBlock, positions):
    """Per-query-position adaLN modulations, a function of the weights only.
    Returns 6 tensors [K, q_dim] (or Nones when time_adaln is off)."""
    if p.adaLN_modulation is None:
        return (None,) * 6
    t_emb = timestep_embedder_apply(p.t_embedder, positions)
    lin = p.adaLN_modulation[1]
    mods = linear(F.silu(t_emb), lin.weight, lin.bias)
    return tuple(torch.chunk(mods, 6, dim=1))


def dual_block_apply(p: DualBlock, cfg: EncoderConfig, x, q, mods, fast_attn=False):
    shift_msa, scale_msa, gate_msa, shift_mlp, scale_mlp, gate_mlp = mods
    s = cfg.ln_scale

    def pre_q_norm(t):
        return t if cfg.post_ln else layer_norm(t)

    def post_q_norm(t):
        return layer_norm(t) if cfg.post_ln else t

    x_attn, q_attn = dual_attention_apply(
        p.attn, cfg, layer_norm(x),
        modulate(pre_q_norm(q), shift_msa, scale_msa, 0), fast_attn=fast_attn)
    x = x + x_attn
    x = x + mlp_apply(p.mlp, layer_norm(x))
    q = post_q_norm(s * q + gate(q_attn, gate_msa))
    q = post_q_norm(s * q + gate(
        mlp_apply(p.q_mlp, modulate(pre_q_norm(q), shift_mlp, scale_mlp, 0)),
        gate_mlp))
    return x, q


# ---------------------------------------------------------------------------
# Encoder
# ---------------------------------------------------------------------------

def _embed_patches(p: QformerEncoder, cfg: EncoderConfig, x):
    """Patchify + positional embedding. x: NHWC [B,H,W,C]."""
    h, w = x.shape[1], x.shape[2]
    tokens = patch_embed_apply(p.x_embedder, x)
    if cfg.pos_embed_max_size is not None:
        pe = crop_pos_embed(p.pos_embed, cfg.pos_embed_max_size,
                            h // cfg.patch_size, w // cfg.patch_size)
    else:
        pe = p.pos_embed
    return tokens + pe.to(tokens.dtype)


def adaln_positions(cfg, length=None):
    """Per-token adaLN position table: diti positions (1000 + 8k) when
    cfg.diti_positions, else arange."""
    L = cfg.K if length is None else length
    return np.asarray(1000 + 8 * np.arange(L) if cfg.diti_positions else np.arange(L))


def _dual_trunk(p: QformerEncoder, cfg: EncoderConfig, x, trunk_dtype=None,
                fast_attn=False):
    """``depth`` DualBlocks. trunk_dtype=bfloat16 + fast_attn=True is the
    serving path: activations run bf16 (weights stay fp32 and are cast at
    use; norm and softmax statistics stay fp32) and the query attention goes
    through ``serving_attention``."""
    positions = (torch.as_tensor(adaln_positions(cfg), dtype=torch.int32,
                                 device=x.device) if cfg.time_adaln else None)
    if trunk_dtype is not None:
        x = x.to(trunk_dtype)
    query = p.query_tokens.expand(x.shape[0], cfg.K, cfg.query_dim).to(x.dtype)
    for blk in p.blocks:
        mods = dual_block_mods(blk, positions)
        # the mods come out fp32; cast so modulate/gate do not promote the
        # query stream back to fp32 on the bf16 path
        mods = tuple(m if m is None else m.to(query.dtype) for m in mods)
        x, query = dual_block_apply(blk, cfg, x, query, mods, fast_attn=fast_attn)
    return query


def get_encoder_outs(p: QformerEncoder, cfg: EncoderConfig, x, trunk_dtype=None,
                     fast_attn=False):
    """Run the trunk; returns the K query tokens."""
    _check_supported(cfg)
    return _dual_trunk(p, cfg, x, trunk_dtype=trunk_dtype, fast_attn=fast_attn)


def get_encoder_mask(cfg: EncoderConfig, d, patches_per_token=1, single_token=False):
    """Token activation mask: token k active iff k <= d. d: [B] int.
    Returns bool [B, K*patches_per_token]."""
    ids = torch.repeat_interleave(torch.arange(cfg.K, device=d.device),
                                  patches_per_token)
    if single_token:
        return ids[None, :] == d[:, None]
    return ids[None, :] <= d[:, None]


def _pre_vq(p: QformerEncoder, cfg: EncoderConfig, x, trunk_dtype, fast_attn):
    x_emb = _embed_patches(p, cfg, x)
    outs = get_encoder_outs(p, cfg, x_emb, trunk_dtype=trunk_dtype, fast_attn=fast_attn)
    if trunk_dtype is not None:
        outs = outs.float()
    if cfg.pre_norm:
        outs = layer_norm(outs, p.final_layer_norm.weight, p.final_layer_norm.bias)
    return outs


def encoder_apply(p: QformerEncoder, cfg: EncoderConfig, x=None, d=None,
                  hidden_states=None, trunk_dtype=None, fast_attn=False):
    """Full encoder forward. x: NHWC latents [B,h,w,C] fp32. d: optional [B]
    int token depth. Returns the 7-tuple when d is given, else
    (outs_q, indices).

    trunk_dtype/fast_attn: the serving path (bf16 trunk, kernel attention,
    ``fast`` VQ scores); patch embed and final norms stay fp32."""
    if hidden_states is None:
        outs = _pre_vq(p, cfg, x, trunk_dtype, fast_attn)
        outs_q, indices, loss, log_dict = vq_mod.vq_apply(
            p.quantizer, outs, fast=trunk_dtype is not None)
        if cfg.post_norm:
            outs_q = layer_norm(outs_q, p.final_layer_norm3.weight,
                                p.final_layer_norm3.bias)
    else:
        outs_q, indices, loss, log_dict = hidden_states, None, 0.0, {}
        outs = None
    if d is None:
        return outs_q, indices
    enc_mask = get_encoder_mask(cfg, d, 1)
    encoder_hidden_states = outs_q * enc_mask[..., None].to(outs_q.dtype)
    return encoder_hidden_states, outs, outs_q, enc_mask, loss, log_dict, indices


def encoder_margins(p: QformerEncoder, cfg: EncoderConfig, x, trunk_dtype=None,
                    fast_attn=False):
    """(ids, VQ top-2 margins [B,K]); trunk_dtype/fast_attn mirror
    encoder_apply so the margins certify the numerics of the path in use."""
    outs = _pre_vq(p, cfg, x, trunk_dtype, fast_attn)
    return vq_mod.vq_margins(p.quantizer, outs, fast=trunk_dtype is not None)
