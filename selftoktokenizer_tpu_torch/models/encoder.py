"""Selftok encoders: the Qformer encoder in its four interaction modes and
the plain ViT encoder (counterpart of the reference ``models/encoder.py``).

Modes (``cfg.qformer_mode``):

* ``dual``: two-stream blocks. Unidirectional (the query attends to
  [image keys || query keys]), bidirectional (one joint self-attention over
  [x || query]) or zero-init (the unidirectional form with the image part
  softmaxed on its own and scaled by ``tanh(gate)``); ``attn_mask`` makes
  the query keys causal.
* ``concat``: ViT blocks over [x || query]; the query update reuses the
  x-stream MLP, as the reference does.
* ``qformer``: stacked cross-attention of the queries over the image tokens
  and an l2-normalised vision projection.
* ``vit``: plain ViT blocks; the outputs of the last K blocks are the K
  token groups, each of ``patches_per_token`` patches.

The multi-resolution encoder (``QformerEncoderMultiRes``,
``multires_encoder_apply``) adds a third stream, the Selftok tokens of a
lower resolution, to unidirectional dual blocks; its attention is plain.

The modules own the weights under the reference checkpoint's names
(``blocks.{i}.attn.qkv.weight``, ``qformer.qformer_blocks.{i}.to_q.weight``,
``x_embedder.proj.weight`` ...); the ``*_apply`` functions, named as in the
reference, do the work. Feature maps are NHWC.

Only the unidirectional dual query attention without a mask takes the
attention kernel (``fast_attn``, the bf16 serving path); every other
attention of the encoders is plain fp32-softmax ``sdpa``, as in the
reference. With ``cfg.gradient_checkpointing`` every dual block runs under
``torch.utils.checkpoint`` while gradients are recorded.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Optional

import numpy as np
import torch
import torch.nn.functional as F
import torch.utils.checkpoint
from torch import nn

from selftoktokenizer_tpu_torch.models import vq as vq_mod
from selftoktokenizer_tpu_torch.ops.attention import sdpa, serving_attention
from selftoktokenizer_tpu_torch.ops.linear import (
    gate, gelu_tanh, linear, linear_apply, modulate, patch_embed)
from selftoktokenizer_tpu_torch.ops.norms import layer_norm, rms_norm
from selftoktokenizer_tpu_torch.ops.posembed import (
    crop_pos_embed, sincos_1d, sincos_2d, timestep_embedding)

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
    # multi-resolution stream (QformerEncoderMultiRes)
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
    """Two-layer MLP with the tanh-approximate GELU; either linear may be a
    Q8Linear (int8 decode)."""
    return linear_apply(m.fc2, gelu_tanh(linear_apply(m.fc1, x)))


class TimestepEmbedder(nn.Module):
    def __init__(self, hidden, dim_freq=256):
        super().__init__()
        self.mlp = nn.Sequential(nn.Linear(dim_freq, hidden), nn.SiLU(),
                                 nn.Linear(hidden, hidden))
        self.dim_freq = dim_freq


def timestep_embedder_apply(m: TimestepEmbedder, t):
    """sinusoid -> Linear -> SiLU -> Linear, each linear through
    ``linear_apply``."""
    h = linear_apply(m.mlp[0], timestep_embedding(t, m.dim_freq))
    return linear_apply(m.mlp[2], F.silu(h))


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
        if not cfg.bidirectional or cfg.zero_init:
            self.to_query_kv = nn.Linear(C, 2 * Cq)
        if cfg.zero_init:
            self.gate = nn.Parameter(torch.zeros(1, cfg.query_heads, 1, 1))
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


class ViTAttention(nn.Module):
    def __init__(self, hidden):
        super().__init__()
        self.qkv = nn.Linear(hidden, 3 * hidden)
        self.proj = nn.Linear(hidden, hidden)


class ViTBlock(nn.Module):
    """A ViT block; with ``adaln`` (the concat mode under time_adaln) also
    the per-query-position modulation of the query stream."""

    def __init__(self, cfg: EncoderConfig, adaln=False):
        super().__init__()
        self.attn = ViTAttention(cfg.hidden_size)
        self.mlp = Mlp(cfg.hidden_size, int(cfg.hidden_size * cfg.mlp_ratio))
        if adaln:
            self.adaLN_modulation = nn.Sequential(
                nn.SiLU(), nn.Linear(cfg.query_dim, 6 * cfg.query_dim))
            self.t_embedder = TimestepEmbedder(cfg.query_dim)
        else:
            self.adaLN_modulation = None


class CrossAttention(nn.Module):
    def __init__(self, dim, c_dim):
        super().__init__()
        self.to_q = nn.Linear(dim, dim)
        self.kv = nn.Linear(c_dim, 2 * dim)
        self.proj = nn.Linear(dim, dim)


class QFormer(nn.Module):
    def __init__(self, cfg: EncoderConfig):
        super().__init__()
        self.qformer_blocks = nn.ModuleList(
            CrossAttention(cfg.query_dim, cfg.hidden_size) for _ in range(cfg.depth))
        self.vision_proj = Mlp(cfg.query_dim, int(cfg.query_dim * cfg.mlp_ratio))


class LayerNormWeight(nn.Module):
    def __init__(self, dim):
        super().__init__()
        self.weight = nn.Parameter(torch.ones(dim))
        self.bias = nn.Parameter(torch.zeros(dim))


class QformerEncoder(nn.Module):
    """Weights of the encoder (any mode) and its quantizer."""

    def __init__(self, cfg: EncoderConfig):
        super().__init__()
        if cfg.qformer_mode not in ("dual", "concat", "qformer", "vit"):
            raise ValueError(f"unknown encoder mode {cfg.qformer_mode!r}")
        self.cfg = cfg
        max_sz = cfg.pos_embed_max_size
        grid = max_sz if max_sz else cfg.input_size // cfg.patch_size
        self.x_embedder = PatchEmbed(cfg.patch_size, cfg.in_channels, cfg.hidden_size)
        # a sincos table at init, and trained like every other leaf
        # (torch.tensor, not from_numpy: built on the default device)
        self.pos_embed = nn.Parameter(torch.tensor(
            sincos_2d(cfg.hidden_size, grid), dtype=torch.float32)[None])
        self.final_layer_norm = LayerNormWeight(cfg.encoder_out_dim)
        self.final_layer_norm2 = LayerNormWeight(cfg.code_dim)
        self.final_layer_norm3 = LayerNormWeight(cfg.encoder_hidden_size)
        self.quantizer = vq_mod.VectorQuantize(
            latent_dim=cfg.encoder_out_dim, code_dim=cfg.code_dim,
            codebook_size=cfg.codebook_size, output_dim=cfg.encoder_hidden_size)
        mode = cfg.qformer_mode
        if mode != "vit":
            self.query_tokens = nn.Parameter(torch.empty(1, cfg.K, cfg.query_dim))
        if mode == "dual":
            self.blocks = nn.ModuleList(DualBlock(cfg) for _ in range(cfg.depth))
        elif mode == "vit":
            self.blocks = nn.ModuleList(ViTBlock(cfg) for _ in range(cfg.depth))
        elif mode == "concat":
            self.blocks = nn.ModuleList(ViTBlock(cfg, adaln=cfg.time_adaln)
                                        for _ in range(cfg.depth))
        else:
            self.qformer = QFormer(cfg)


# ---------------------------------------------------------------------------
# DualAttention / DualBlock
# ---------------------------------------------------------------------------

def _merge_heads(t):
    b, h, n, d = t.shape
    return t.permute(0, 2, 1, 3).reshape(b, n, h * d)


def dual_attention_apply(p: DualAttention, cfg: EncoderConfig, x, query, mask=None,
                         fast_attn=False, x_mask=None):
    """Two-stream attention. x: [B,N,C] image stream; query: [B,K,Cq].

    Unidirectional: x self-attends; the query attends to [x-derived KV ||
    query KV], image keys first. Bidirectional: one joint self-attention
    over [x || query]. Zero-init: the unidirectional form with the image
    keys and the query keys each softmaxed on their own, the image part
    scaled by tanh(gate) per head, in fp32. mask: the query rows' boolean
    mask [1, 1, K, N+K] (``attn_mask``), or in the bidirectional form the
    joint rows'; x_mask: the x rows' boolean mask of the unidirectional and
    zero-init forms (the DiT dual block's).

    fast_attn routes the unidirectional query attention without a mask
    through ``serving_attention`` (the CUDA kernel); every other attention
    is plain fp32-softmax sdpa. The x-stream self-attention (head dim 16 at
    the flagship) is always plain.
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

    if cfg.bidirectional and not cfg.zero_init:
        if cfg.qk_norm:
            qq = rms_norm(qq, p.query_qnorm.weight)
            qk = rms_norm(qk, p.query_knorm.weight)
        out = sdpa(torch.cat([xq, qq], dim=2), torch.cat([xk, qk], dim=2),
                   torch.cat([xv, qv], dim=2), mask=mask)
        x_out, q_out = out[:, :, :N], out[:, :, N:]
    else:
        kv = linear(x, p.to_query_kv.weight, p.to_query_kv.bias).reshape(
            B, N, 2, QH, Cq // QH).permute(2, 0, 3, 1, 4)
        x_out = sdpa(xq, xk, xv, mask=x_mask)
        k2 = torch.cat([kv[0], qk], dim=2)
        v2 = torch.cat([kv[1], qv], dim=2)
        if cfg.qk_norm:
            qq = rms_norm(qq, p.query_qnorm.weight)
            k2 = rms_norm(k2, p.query_knorm.weight)
        if cfg.zero_init:
            scores = torch.matmul(qq.float(), k2.float().transpose(-1, -2)) * (
                1.0 / math.sqrt(Cq // QH))
            if mask is not None:
                scores = scores.masked_fill(~mask, float("-inf"))
            w = torch.cat([torch.tanh(p.gate.float()) * torch.softmax(scores[..., :N], dim=-1),
                           torch.softmax(scores[..., N:], dim=-1)], dim=-1)
            q_out = torch.matmul(w.to(qq.dtype), v2)
        elif fast_attn and mask is None:
            q_out = serving_attention(qq, k2, v2)
        else:
            q_out = sdpa(qq, k2, v2, mask=mask)

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


def dual_block_apply(p: DualBlock, cfg: EncoderConfig, x, q, mods, mask=None,
                     fast_attn=False):
    shift_msa, scale_msa, gate_msa, shift_mlp, scale_mlp, gate_mlp = mods
    s = cfg.ln_scale

    def pre_q_norm(t):
        return t if cfg.post_ln else layer_norm(t)

    def post_q_norm(t):
        return layer_norm(t) if cfg.post_ln else t

    x_attn, q_attn = dual_attention_apply(
        p.attn, cfg, layer_norm(x),
        modulate(pre_q_norm(q), shift_msa, scale_msa, 0), mask=mask, fast_attn=fast_attn)
    x = x + x_attn
    x = x + mlp_apply(p.mlp, layer_norm(x))
    q = post_q_norm(s * q + gate(q_attn, gate_msa))
    q = post_q_norm(s * q + gate(
        mlp_apply(p.q_mlp, modulate(pre_q_norm(q), shift_mlp, scale_mlp, 0)),
        gate_mlp))
    return x, q


# ---------------------------------------------------------------------------
# ViT block, ConcatBlock, CrossAttention / QFormer
# ---------------------------------------------------------------------------

def vit_attention_apply(p: ViTAttention, heads, x):
    B, N, C = x.shape
    qkv = linear(x, p.qkv.weight, p.qkv.bias).reshape(
        B, N, 3, heads, C // heads).permute(2, 0, 3, 1, 4)
    out = sdpa(qkv[0], qkv[1], qkv[2])
    return linear(_merge_heads(out), p.proj.weight, p.proj.bias)


def vit_block_apply(p: ViTBlock, heads, x):
    x = x + vit_attention_apply(p.attn, heads, layer_norm(x))
    return x + mlp_apply(p.mlp, layer_norm(x))


def concat_block_apply(p: ViTBlock, cfg: EncoderConfig, x, q, mods):
    """Joint self-attention over [x || q]; the q update reuses the x-stream
    MLP, as the reference's ConcatBlock does."""
    shift_msa, scale_msa, gate_msa, shift_mlp, scale_mlp, gate_mlp = mods
    N = x.shape[1]
    joint = torch.cat([layer_norm(x), modulate(layer_norm(q), shift_msa, scale_msa, 0)],
                      dim=1)
    attn = vit_attention_apply(p.attn, cfg.num_heads, joint)
    x = x + attn[:, :N]
    q = q + gate(attn[:, N:], gate_msa)
    x = x + mlp_apply(p.mlp, layer_norm(x))
    q = q + gate(mlp_apply(p.mlp, modulate(layer_norm(q), shift_mlp, scale_mlp, 0)),
                 gate_mlp)
    return x, q


def cross_attention_apply(p: CrossAttention, heads, x, c, mask=None):
    """The queries x [B,K,D] attend over c [B,N,c_dim]; mask: an optional
    [B, N] keep-mask over c (masked keys get -inf, as in the reference)."""
    B, K, D = x.shape
    kv = linear(c, p.kv.weight, p.kv.bias).reshape(
        B, c.shape[1], 2, heads, D // heads).permute(2, 0, 3, 1, 4)
    q = linear(x, p.to_q.weight, p.to_q.bias).reshape(
        B, K, heads, D // heads).permute(0, 2, 1, 3)
    bias = None
    if mask is not None:
        bias = torch.where(mask[:, None, None, :], 0.0, float("-inf")).to(torch.float32)
    out = sdpa(q, kv[0], kv[1], mask=bias)
    return linear(_merge_heads(out), p.proj.weight, p.proj.bias)


def qformer_apply(p: QFormer, heads, image_feats, query_tokens):
    """Stacked cross-attention, then the l2-normalised vision projection."""
    q = query_tokens
    for bp in p.qformer_blocks:
        q = cross_attention_apply(bp, heads, q, image_feats)
    proj = mlp_apply(p.vision_proj, q)
    return proj / torch.clamp(torch.linalg.vector_norm(proj, dim=-1, keepdim=True),
                              min=1e-12)


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


def _positions(cfg, device):
    return (torch.as_tensor(adaln_positions(cfg), dtype=torch.int32, device=device)
            if cfg.time_adaln else None)


def _query(p: QformerEncoder, cfg: EncoderConfig, x):
    return p.query_tokens.expand(x.shape[0], cfg.K, cfg.query_dim).to(x.dtype)


def _dual_trunk(p: QformerEncoder, cfg: EncoderConfig, x, mask=None, trunk_dtype=None,
                fast_attn=False):
    """``depth`` DualBlocks. trunk_dtype=bfloat16 + fast_attn=True is the
    serving path: activations run bf16 (weights stay fp32 and are cast at
    use; norm and softmax statistics stay fp32) and the unidirectional query
    attention goes through ``serving_attention``."""
    positions = _positions(cfg, x.device)
    if trunk_dtype is not None:
        x = x.to(trunk_dtype)
    query = _query(p, cfg, x)

    def block(blk, x, query):
        mods = dual_block_mods(blk, positions)
        # the mods come out fp32; cast so modulate/gate do not promote the
        # query stream back to fp32 on the bf16 path
        mods = tuple(m if m is None else m.to(query.dtype) for m in mods)
        return dual_block_apply(blk, cfg, x, query, mods, mask=mask, fast_attn=fast_attn)

    remat = cfg.gradient_checkpointing and torch.is_grad_enabled()
    for blk in p.blocks:
        if remat:
            x, query = torch.utils.checkpoint.checkpoint(block, blk, x, query,
                                                         use_reentrant=False)
        else:
            x, query = block(blk, x, query)
    return query


def query_causal_mask(cfg: EncoderConfig, n_image, device):
    """``attn_mask``: the query rows' mask [1, 1, K, N+K], every image key
    visible and the query keys causal."""
    tril = torch.tril(torch.ones((cfg.K, cfg.K), dtype=torch.bool, device=device))
    return torch.cat([torch.ones((cfg.K, n_image), dtype=torch.bool, device=device), tril],
                     dim=1)[None, None]


def get_encoder_outs(p: QformerEncoder, cfg: EncoderConfig, x, trunk_dtype=None,
                     fast_attn=False):
    """Run the trunk on the embedded patches x [B,N,C]; returns the K query
    tokens, or for ``vit`` the last K blocks' outputs as K token groups
    [B, K*N, C]. trunk_dtype / fast_attn apply to the dual trunk only (the
    serving path); the other modes run at the input's type."""
    mode = cfg.qformer_mode
    if mode == "dual":
        mask = None
        if cfg.attn_mask:
            if cfg.bidirectional:
                # the [K, N+K] mask cannot apply to the joint (N+K)-row
                # attention; the reference fails on the same combination
                raise ValueError(
                    "attn_mask=True is unsupported with bidirectional=True "
                    "(no reference config combines them; the reference "
                    "errors identically)")
            mask = query_causal_mask(cfg, x.shape[1], x.device)
        return _dual_trunk(p, cfg, x, mask=mask, trunk_dtype=trunk_dtype,
                           fast_attn=fast_attn)
    if mode == "concat":
        positions = _positions(cfg, x.device)
        query = _query(p, cfg, x)
        for blk in p.blocks:
            x, query = concat_block_apply(blk, cfg, x, query, dual_block_mods(blk, positions))
        return query
    if mode == "qformer":
        return qformer_apply(p.qformer, cfg.num_heads, x, _query(p, cfg, x))
    outs = []
    for i, blk in enumerate(p.blocks):
        x = vit_block_apply(blk, cfg.num_heads, x)
        if i >= cfg.depth - cfg.K:
            outs.append(x)
    return torch.cat(outs, dim=1)


def patches_per_token(cfg: EncoderConfig, x_emb):
    """Patches in one token: the image's patch count for ``vit``, else 1."""
    return x_emb.shape[1] if cfg.qformer_mode == "vit" else 1


def get_encoder_mask(cfg: EncoderConfig, d, patches_per_token=1, single_token=False):
    """Token activation mask: token k active iff k <= d. d: [B] int.
    Returns bool [B, K*patches_per_token]."""
    ids = torch.repeat_interleave(torch.arange(cfg.K, device=d.device),
                                  patches_per_token)
    if single_token:
        return ids[None, :] == d[:, None]
    return ids[None, :] <= d[:, None]


def _pre_vq(p: QformerEncoder, cfg: EncoderConfig, x, trunk_dtype, fast_attn):
    """(quantizer input, patches per token)."""
    x_emb = _embed_patches(p, cfg, x)
    outs = get_encoder_outs(p, cfg, x_emb, trunk_dtype=trunk_dtype, fast_attn=fast_attn)
    if trunk_dtype is not None:
        outs = outs.float()
    if cfg.pre_norm:
        outs = layer_norm(outs, p.final_layer_norm.weight, p.final_layer_norm.bias)
    return outs, patches_per_token(cfg, x_emb)


def encoder_apply(p: QformerEncoder, cfg: EncoderConfig, x=None, d=None,
                  hidden_states=None, trunk_dtype=None, fast_attn=False):
    """Full encoder forward. x: NHWC latents [B,h,w,C] fp32. d: optional [B]
    int token depth. Returns the 7-tuple when d is given, else
    (outs_q, indices).

    trunk_dtype/fast_attn: the serving path (bf16 trunk, kernel attention,
    ``fast`` VQ scores); patch embed and final norms stay fp32."""
    ppt = 1
    if hidden_states is None:
        outs, ppt = _pre_vq(p, cfg, x, trunk_dtype, fast_attn)
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
    if hidden_states is not None and cfg.qformer_mode == "vit":
        ppt = hidden_states.shape[1] // cfg.K
    enc_mask = get_encoder_mask(cfg, d, ppt)
    encoder_hidden_states = outs_q * enc_mask[..., None].to(outs_q.dtype)
    return encoder_hidden_states, outs, outs_q, enc_mask, loss, log_dict, indices


def encoder_margins(p: QformerEncoder, cfg: EncoderConfig, x, trunk_dtype=None,
                    fast_attn=False):
    """(ids, VQ top-2 margins [B,K]); trunk_dtype/fast_attn mirror
    encoder_apply so the margins certify the numerics of the path in use."""
    outs, _ = _pre_vq(p, cfg, x, trunk_dtype, fast_attn)
    return vq_mod.vq_margins(p.quantizer, outs, fast=trunk_dtype is not None)


# ---------------------------------------------------------------------------
# Multi-resolution encoder (QformerEncoderMultiRes)
# ---------------------------------------------------------------------------

class DualAttentionMultiRes(nn.Module):
    """Three streams: x, the query and the low-res Selftok tokens. The four
    input projections carry no bias."""

    def __init__(self, cfg: EncoderConfig):
        super().__init__()
        C, Cq, Cl = cfg.hidden_size, cfg.query_dim, cfg.low_res_hidden_size
        self.qkv = nn.Linear(C, 3 * C, bias=False)
        self.query_linear = nn.Linear(Cq, 3 * Cq, bias=False)
        self.low_res_linear = nn.Linear(Cl, 3 * Cl, bias=False)
        self.x_to_query_kv = nn.Linear(C, 2 * Cq, bias=False)
        self.low_res_to_query_kv = nn.Linear(Cl, 2 * Cq, bias=False)
        self.proj = nn.Linear(C, C)
        self.query_proj = nn.Linear(Cq, Cq)
        self.low_res_proj = nn.Linear(Cl, Cl)


class DualBlockMultiRes(nn.Module):
    def __init__(self, cfg: EncoderConfig):
        super().__init__()
        C, Cq, Cl = cfg.hidden_size, cfg.query_dim, cfg.low_res_hidden_size
        self.attn = DualAttentionMultiRes(cfg)
        self.mlp = Mlp(C, int(C * cfg.mlp_ratio))
        self.q_mlp = Mlp(Cq, int(Cq * cfg.mlp_ratio))
        self.low_res_mlp = Mlp(Cl, int(Cl * cfg.mlp_ratio))
        if cfg.time_adaln:
            self.adaLN_modulation = nn.Sequential(nn.SiLU(), nn.Linear(Cq, 6 * Cq))
            self.t_embedder = TimestepEmbedder(Cq)
            self.adaLN_modulation_low_res = nn.Sequential(nn.SiLU(), nn.Linear(Cl, 6 * Cl))
            self.t_embedder_low_res = TimestepEmbedder(Cl)
        else:
            self.adaLN_modulation = self.adaLN_modulation_low_res = None


class QformerEncoderMultiRes(QformerEncoder):
    """Weights of the multi-resolution encoder: the dual encoder's patch
    embedding, tables, norms, quantizer and query tokens, multi-resolution
    dual blocks, a token embedder for the low-res stream (only when its code
    width differs from its hidden width) and that stream's 1-D sincos
    positions. The blocks are dual whatever ``qformer_mode`` says."""

    def __init__(self, cfg: EncoderConfig):
        if cfg.qk_norm:
            raise ValueError("the multi-resolution encoder has no qk-norm weights")
        super().__init__(dataclasses.replace(cfg, qformer_mode="dual"))
        self.cfg = cfg
        self.blocks = nn.ModuleList(DualBlockMultiRes(cfg) for _ in range(cfg.depth))
        if cfg.low_res_code_dim != cfg.low_res_hidden_size:
            self.token_embedder = nn.Linear(cfg.low_res_code_dim, cfg.low_res_hidden_size)
        self.low_res_hidden_pos_embed = nn.Parameter(torch.tensor(
            sincos_1d(cfg.low_res_hidden_size, np.arange(cfg.low_res_K, dtype=np.float32)),
            dtype=torch.float32)[None])


def _qkv_heads(t, parts, heads):
    """[B, L, parts*C] -> parts x [B, heads, L, C/heads]."""
    B, L, C = t.shape
    return t.reshape(B, L, parts, heads, C // (parts * heads)).permute(2, 0, 3, 1, 4)


def dual_attention_multires_apply(p: DualAttentionMultiRes, cfg: EncoderConfig, x, query,
                                  low_res, mask=None, x_mask=None, low_res_mask=None):
    """Three-stream attention, unidirectional: x self-attends, the low-res
    stream self-attends with ``low_res_heads``, the query attends over
    [x -> query KV || low-res -> query KV || query KV]. All plain fp32-softmax
    ``sdpa``."""
    H, QH, LH = cfg.num_heads, cfg.query_heads, cfg.low_res_heads
    xq, xk, xv = _qkv_heads(linear(x, p.qkv.weight), 3, H)
    lq, lk, lv = _qkv_heads(linear(low_res, p.low_res_linear.weight), 3, LH)
    qq, qk, qv = _qkv_heads(linear(query, p.query_linear.weight), 3, QH)
    x_kv = _qkv_heads(linear(x, p.x_to_query_kv.weight), 2, QH)
    l_kv = _qkv_heads(linear(low_res, p.low_res_to_query_kv.weight), 2, QH)

    x_out = sdpa(xq, xk, xv, mask=x_mask)
    l_out = sdpa(lq, lk, lv, mask=low_res_mask)
    q_out = sdpa(qq, torch.cat([x_kv[0], l_kv[0], qk], dim=2),
                 torch.cat([x_kv[1], l_kv[1], qv], dim=2), mask=mask)
    return (linear(_merge_heads(x_out), p.proj.weight, p.proj.bias),
            linear(_merge_heads(q_out), p.query_proj.weight, p.query_proj.bias),
            linear(_merge_heads(l_out), p.low_res_proj.weight, p.low_res_proj.bias))


def dual_block_multires_mods(p: DualBlockMultiRes, K, K_low, device):
    """adaLN modulations of the query and the low-res streams (6 tensors
    each, or Nones without time_adaln): plain positions K_low..K_low+K-1
    for the query and 0..K_low-1 for the low-res stream, not the diti
    positions 1000 + 8k."""
    if p.adaLN_modulation is None:
        return (None,) * 6, (None,) * 6
    pos_q = torch.arange(K_low, K_low + K, dtype=torch.int32, device=device)
    pos_l = torch.arange(K_low, dtype=torch.int32, device=device)
    lin, lin_l = p.adaLN_modulation[1], p.adaLN_modulation_low_res[1]
    mods = linear(F.silu(timestep_embedder_apply(p.t_embedder, pos_q)), lin.weight, lin.bias)
    low = linear(F.silu(timestep_embedder_apply(p.t_embedder_low_res, pos_l)),
                 lin_l.weight, lin_l.bias)
    return tuple(torch.chunk(mods, 6, dim=1)), tuple(torch.chunk(low, 6, dim=1))


def dual_block_multires_apply(p: DualBlockMultiRes, cfg: EncoderConfig, x, q, low_res, mods,
                              low_mods, mask=None):
    """The low-res stream mirrors the query stream's structure after the
    attention."""
    shift_msa, scale_msa, gate_msa, shift_mlp, scale_mlp, gate_mlp = mods
    lsm, lsc, lgm, lsm2, lsc2, lgm2 = low_mods
    s = cfg.ln_scale
    x_attn, q_attn, l_attn = dual_attention_multires_apply(
        p.attn, cfg, layer_norm(x), modulate(layer_norm(q), shift_msa, scale_msa, 0),
        modulate(layer_norm(low_res), lsm, lsc, 0), mask=mask)
    x = x + x_attn
    x = x + mlp_apply(p.mlp, layer_norm(x))
    q = s * q + gate(q_attn, gate_msa)
    q = s * q + gate(mlp_apply(p.q_mlp, modulate(layer_norm(q), shift_mlp, scale_mlp, 0)),
                     gate_mlp)
    low_res = s * low_res + gate(l_attn, lgm)
    low_res = s * low_res + gate(
        mlp_apply(p.low_res_mlp, modulate(layer_norm(low_res), lsm2, lsc2, 0)), lgm2)
    return x, q, low_res


def multires_encoder_outs(p: QformerEncoderMultiRes, cfg: EncoderConfig, x, token_embeds):
    """The three-stream trunk on the embedded patches x [B,N,C] and the
    low-res stream's token embeddings [B, low_res_K, low_res_code_dim];
    returns the K query tokens."""
    low = token_embeds
    if hasattr(p, "token_embedder"):
        low = linear(low, p.token_embedder.weight, p.token_embedder.bias)
    low = low + p.low_res_hidden_pos_embed.to(low.dtype)
    query = _query(p, cfg, x)
    for blk in p.blocks:
        mods, low_mods = dual_block_multires_mods(blk, cfg.K, cfg.low_res_K, x.device)
        x, query, low = dual_block_multires_apply(blk, cfg, x, query, low, mods, low_mods)
    return query


def multires_encoder_apply(p: QformerEncoderMultiRes, cfg: EncoderConfig, x, token_embeds,
                           d=None):
    """The multi-resolution encoder's forward with quantization (fp32; the
    quantizer is the ordinary ``vq_apply``, so on the card it takes
    ``vq_argmax``). x: NHWC latents; token_embeds: [B, low_res_K,
    low_res_code_dim]; d: optional [B] int token depth. Returns the 7-tuple
    of ``encoder_apply`` when d is given, else (outs_q, indices)."""
    outs = multires_encoder_outs(p, cfg, _embed_patches(p, cfg, x), token_embeds)
    if cfg.pre_norm:
        outs = layer_norm(outs, p.final_layer_norm.weight, p.final_layer_norm.bias)
    outs_q, indices, loss, log_dict = vq_mod.vq_apply(p.quantizer, outs)
    if cfg.post_norm:
        outs_q = layer_norm(outs_q, p.final_layer_norm3.weight, p.final_layer_norm3.bias)
    if d is None:
        return outs_q, indices
    enc_mask = get_encoder_mask(cfg, d)
    ehs = outs_q * enc_mask[..., None].to(outs_q.dtype)
    return ehs, outs, outs_q, enc_mask, loss, log_dict, indices
