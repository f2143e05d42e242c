"""MMDiT: the SD3-style joint-attention diffusion decoder (counterpart of
the reference ``models/mmdit.py:49-616``).

The modules own the weights under the reference checkpoint's names
(``joint_blocks.{i}.x_block.attn.qkv.weight``, the last joint block with a
pre-only context branch, ...); the functions, named as in the reference, do
the work. The joint attention of every block goes through
``ops.attention.serving_attention`` -> the CUDA kernel, for bf16 and fp32
alike. The context stream's per-position adaLN table depends only on the
weights and is computed once (``precompute_context_mods``).

Not ported yet (each raises NotImplementedError naming its ROADMAP.md queue
item): the renderer, ``register_length > 0`` under CFG
(``mmdit_cfg_inference``), ``mmdit_cfg_batched``, ``context_see_xt=False``,
pooled conditioning, qk-norm 'ln', the 'pos_t_emb' mode.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from selftoktokenizer_tpu_torch.models.encoder import (
    Mlp, PatchEmbed, RMSNormWeight, TimestepEmbedder, mlp_apply,
    patch_embed_apply, timestep_embedder_apply)
from selftoktokenizer_tpu_torch.ops.attention import serving_attention
from selftoktokenizer_tpu_torch.ops.linear import linear, modulate, unpatchify
from selftoktokenizer_tpu_torch.ops.norms import layer_norm, rms_norm
from selftoktokenizer_tpu_torch.ops.posembed import crop_pos_embed, sincos_1d


@dataclasses.dataclass
class MMDiTConfig:
    depth: int = 24
    K: int = 512
    patch_size: int = 2
    in_channels: int = 16
    out_channels: Optional[int] = None
    mlp_ratio: float = 4.0
    pos_embed_max_size: int = 192
    num_patches: int = 36864
    encoder_hidden_size: int = 16       # context in_features
    context_dim: int = 1536             # context_embedder out_features
    adm_in_channels: Optional[int] = 16
    class_dropout_prob: float = 0.1
    time_adaln: str = "pos_emb"         # context-stream adaLN mode
    qkv_bias: bool = True
    qk_norm: Optional[str] = None       # None | 'rms' | 'ln'
    register_length: int = 0
    sd3_cond_pooling: Optional[str] = None
    uncond_y_file: Optional[str] = None
    uncond_c_file: Optional[str] = None
    diti_positions: bool = True
    renderer: bool = False
    input_size: int = 32
    repeat_mask_token: bool = False
    # kept so configs compare equal with the reference's; the port always
    # takes the kernel route (ops.attention.serving_attention)
    use_flash_attention: bool = True
    serving_attention: bool = True
    use_checkpoint: bool = False
    hidden_override: Optional[int] = None

    def __post_init__(self):
        if self.hidden_override is not None and self.hidden_override % 64:
            raise ValueError(
                f"hidden_override={self.hidden_override} must be a "
                f"multiple of 64 (head_dim)")

    @property
    def hidden_size(self):
        if self.hidden_override is not None:
            return self.hidden_override
        return 64 * self.depth

    @property
    def num_heads(self):
        return self.hidden_size // 64   # head_dim 64 across the family

    @property
    def out_ch(self):
        return self.out_channels if self.out_channels is not None else self.in_channels


def _check_supported(cfg: MMDiTConfig):
    if cfg.renderer:
        raise NotImplementedError(
            "the renderer (renderer_apply, decoding_with_renderer) is not "
            "ported yet: ROADMAP.md queue item 'renderer'")
    later = ("ROADMAP.md queue item 'remaining encoder modes / multires / DiT "
             "/ DDPM / text encoders'")
    if cfg.time_adaln not in ("pos_emb", "t_emb"):
        raise NotImplementedError(f"time_adaln={cfg.time_adaln!r} is not ported yet: {later}")
    if cfg.qk_norm not in (None, "rms"):
        raise NotImplementedError(f"qk_norm={cfg.qk_norm!r} is not ported yet: {later}")
    if cfg.sd3_cond_pooling:
        raise NotImplementedError(f"sd3_cond_pooling is not ported yet: {later}")


# ---------------------------------------------------------------------------
# weight-owning modules (reference checkpoint names)
# ---------------------------------------------------------------------------

class _Attn(nn.Module):
    def __init__(self, cfg: MMDiTConfig, pre_only):
        super().__init__()
        D = cfg.hidden_size
        self.qkv = nn.Linear(D, 3 * D, bias=cfg.qkv_bias)
        if cfg.qk_norm == "rms":
            self.ln_q = RMSNormWeight(D // cfg.num_heads)
            self.ln_k = RMSNormWeight(D // cfg.num_heads)
        if not pre_only:
            self.proj = nn.Linear(D, D)


class DismantledBlock(nn.Module):
    def __init__(self, cfg: MMDiTConfig, pre_only=False, pos_embedder=False):
        super().__init__()
        D = cfg.hidden_size
        self.pre_only = pre_only
        self.attn = _Attn(cfg, pre_only)
        self.adaLN_modulation = nn.Sequential(
            nn.SiLU(), nn.Linear(D, (2 if pre_only else 6) * D))
        if not pre_only:
            self.mlp = Mlp(D, int(D * cfg.mlp_ratio))
        if pos_embedder and not pre_only:
            self.t_embedder = TimestepEmbedder(D)


class JointBlock(nn.Module):
    def __init__(self, cfg: MMDiTConfig, last=False):
        super().__init__()
        self.context_block = DismantledBlock(
            cfg, pre_only=last, pos_embedder=cfg.time_adaln == "pos_emb")
        self.x_block = DismantledBlock(cfg)


class FinalLayer(nn.Module):
    def __init__(self, cfg: MMDiTConfig):
        super().__init__()
        D = cfg.hidden_size
        self.linear = nn.Linear(D, cfg.patch_size ** 2 * cfg.out_ch)
        self.adaLN_modulation = nn.Sequential(nn.SiLU(), nn.Linear(D, 2 * D))


class MMDiT(nn.Module):
    """Weights of the decoder. ``joint_blocks[depth-1]`` is the last block,
    whose context branch is pre-only."""

    def __init__(self, cfg: MMDiTConfig):
        super().__init__()
        _check_supported(cfg)
        self.cfg = cfg
        D = cfg.hidden_size
        self.t_embedder = TimestepEmbedder(D)
        self.context_embedder = nn.Linear(cfg.encoder_hidden_size, cfg.context_dim)
        self.final_layer = FinalLayer(cfg)
        self.x_embedder = PatchEmbed(cfg.patch_size, cfg.in_channels, D)
        self.pos_embed = nn.Parameter(torch.zeros(1, cfg.num_patches, D))
        if cfg.adm_in_channels is not None:
            # part of the checkpoint; only pooled conditioning reads it
            self.y_embedder = TimestepEmbedder(D, dim_freq=cfg.adm_in_channels)
        base = 1000 + 8 * np.arange(cfg.K) if cfg.diti_positions else np.arange(cfg.K)
        self.register_buffer("context_pos_embed", torch.from_numpy(
            sincos_1d(cfg.context_dim, base.astype(np.float32))).float()[None])
        if cfg.register_length > 0:
            self.register = nn.Parameter(torch.empty(1, cfg.register_length, D))
        self.joint_blocks = nn.ModuleList(
            JointBlock(cfg, last=i == cfg.depth - 1) for i in range(cfg.depth))


# ---------------------------------------------------------------------------
# DismantledBlock
# ---------------------------------------------------------------------------

def _adaln(p, c):
    lin = p.adaLN_modulation[1]
    return linear(F.silu(c), lin.weight, lin.bias)


def _qkv_split(p: DismantledBlock, cfg: MMDiTConfig, x):
    """qkv linear + optional per-head q/k norm, flat [B,L,C] -> 3x[B,H,L,D]."""
    B, L, C = x.shape
    H = cfg.num_heads
    qkv = linear(x, p.attn.qkv.weight, p.attn.qkv.bias).reshape(B, L, 3, H, C // H)
    q, k, v = qkv[:, :, 0], qkv[:, :, 1], qkv[:, :, 2]
    if cfg.qk_norm == "rms":
        q = rms_norm(q, p.attn.ln_q.weight)
        k = rms_norm(k, p.attn.ln_k.weight)
    return q.permute(0, 2, 1, 3), k.permute(0, 2, 1, 3), v.permute(0, 2, 1, 3)


def dismantled_pre_attention(p: DismantledBlock, cfg: MMDiTConfig, x, c,
                             pos_mods=None, pre_only=False):
    """pos_mods: precomputed [K, 6*hidden] context modulations when the block
    runs in 'pos_emb' mode (else None -> 't_emb' mode driven by c).
    Returns (q, k, v), intermediates."""
    if pre_only:
        shift_msa, scale_msa = torch.chunk(_adaln(p, c), 2, dim=-1)
        qkv = _qkv_split(p, cfg, modulate(layer_norm(x), shift_msa, scale_msa, 1))
        return qkv, None
    if pos_mods is not None:
        mods, axis = pos_mods, 0
    else:
        mods, axis = _adaln(p, c), 1
    shift_msa, scale_msa, gate_msa, shift_mlp, scale_mlp, gate_mlp = \
        torch.chunk(mods, 6, dim=-1)
    qkv = _qkv_split(p, cfg, modulate(layer_norm(x), shift_msa, scale_msa, axis))
    return qkv, (x, gate_msa, shift_mlp, scale_mlp, gate_mlp, axis)


def dismantled_post_attention(p: DismantledBlock, attn_out, inter):
    """attn_out: [B, L, C]."""
    x, gate_msa, shift_mlp, scale_mlp, gate_mlp, axis = inter
    x = x + gate_msa.unsqueeze(axis) * linear(attn_out, p.attn.proj.weight,
                                              p.attn.proj.bias)
    x = x + gate_mlp.unsqueeze(axis) * mlp_apply(
        p.mlp, modulate(layer_norm(x), shift_mlp, scale_mlp, axis))
    return x


def joint_block_apply(bp: JointBlock, cfg: MMDiTConfig, context, x, c,
                      pos_mods=None, key_mask=None, last=False):
    """One JointBlock: separate pre-attention per stream, one concatenated
    attention (context keys first), separate post-attention.
    Returns (context', x')."""
    ctx_qkv, ctx_inter = dismantled_pre_attention(
        bp.context_block, cfg, context, c,
        pos_mods=None if last else pos_mods, pre_only=last)
    x_qkv, x_inter = dismantled_pre_attention(bp.x_block, cfg, x, c)

    q = torch.cat([ctx_qkv[0], x_qkv[0]], dim=2)
    k = torch.cat([ctx_qkv[1], x_qkv[1]], dim=2)
    v = torch.cat([ctx_qkv[2], x_qkv[2]], dim=2)
    attn = serving_attention(q, k, v, key_mask)
    Lc = context.shape[1]
    b, h, L, d = attn.shape
    attn = attn.permute(0, 2, 1, 3).reshape(b, L, h * d)
    ctx_attn, x_attn = attn[:, :Lc], attn[:, Lc:]

    new_ctx = None if last else dismantled_post_attention(
        bp.context_block, ctx_attn, ctx_inter)
    new_x = dismantled_post_attention(bp.x_block, x_attn, x_inter)
    return new_ctx, new_x


def precompute_context_mods(params: MMDiT, cfg: MMDiTConfig, length=None):
    """Context adaLN table [depth-1, K, 6*hidden], a function of the weights
    only; hoisting it removes t_embedder + adaLN of every context block from
    the 50-step decode loop."""
    if cfg.time_adaln != "pos_emb":
        return None
    L = length if length is not None else cfg.register_length + cfg.K
    base = 1000 + 8 * np.arange(L) if cfg.diti_positions else np.arange(L)
    positions = torch.as_tensor(base, dtype=torch.float32,
                                device=params.pos_embed.device)
    mods = []
    for bp in list(params.joint_blocks)[:-1]:
        t_emb = timestep_embedder_apply(bp.context_block.t_embedder, positions)
        mods.append(_adaln(bp.context_block, t_emb))
    return torch.stack(mods)


def final_layer_apply(p: FinalLayer, x, c):
    shift, scale = torch.chunk(_adaln(p, c), 2, dim=-1)
    return linear(modulate(layer_norm(x), shift, scale, 1),
                  p.linear.weight, p.linear.bias)


# ---------------------------------------------------------------------------
# MMDiT
# ---------------------------------------------------------------------------

def _trunk(params: MMDiT, cfg: MMDiTConfig, context, x, c, ctx_mods, key_mask=None):
    """depth-1 joint blocks + the final pre-only block + final layer."""
    if ctx_mods is not None:
        ctx_mods = ctx_mods.to(context.dtype)
    blocks = list(params.joint_blocks)
    for i, bp in enumerate(blocks[:-1]):
        context, x = joint_block_apply(
            bp, cfg, context, x, c,
            pos_mods=None if ctx_mods is None else ctx_mods[i], key_mask=key_mask)
    _, x = joint_block_apply(blocks[-1], cfg, context, x, c, key_mask=key_mask,
                             last=True)
    return final_layer_apply(params.final_layer, x, c)


def build_decode_key_mask(token_mask, n_x, register_length=0):
    """[B,K] token mask -> [B, reg+K+Nx] key mask (all rows equal because
    context_see_xt=True on the decode path)."""
    B = token_mask.shape[0]
    dev = token_mask.device
    parts = []
    if register_length:
        parts.append(torch.ones((B, register_length), dtype=torch.bool, device=dev))
    parts.append(token_mask.bool())
    parts.append(torch.ones((B, n_x), dtype=torch.bool, device=dev))
    return torch.cat(parts, dim=1)


def _embed_x(params: MMDiT, cfg: MMDiTConfig, x):
    B, h, w, _ = x.shape
    gh, gw = h // cfg.patch_size, w // cfg.patch_size
    xt = patch_embed_apply(params.x_embedder, x)
    xt = xt + crop_pos_embed(params.pos_embed, cfg.pos_embed_max_size,
                             gh, gw).to(xt.dtype)
    return xt, gh, gw


def mmdit_apply(params: MMDiT, cfg: MMDiTConfig, x, t, encoder_hidden_states,
                mask=None, context_see_xt=True, ctx_mods=None):
    """MMDiT forward, eval semantics.

    x: NHWC noised latents [B,h,w,C]; t: [B] in [0,1] (scaled x1000 inside);
    encoder_hidden_states: [B,Lc,encoder_hidden_size], Lc a prefix of K;
    mask: [B,Lc] bool. Returns the NHWC velocity field."""
    if not context_see_xt:
        raise NotImplementedError(
            "context_see_xt=False (the full [B,1,L,L] mask) is not ported "
            "yet: ROADMAP.md queue item 'training'")
    B = x.shape[0]
    xt, gh, gw = _embed_x(params, cfg, x)
    c = timestep_embedder_apply(params.t_embedder, t * 1000.0).to(xt.dtype)

    Lc = encoder_hidden_states.shape[1]
    ce = params.context_embedder
    context = linear(encoder_hidden_states, ce.weight, ce.bias)
    context = (context + params.context_pos_embed[:, :Lc]).to(xt.dtype)

    if mask is None:
        mask = torch.ones((B, Lc), dtype=torch.bool, device=x.device)
    if ctx_mods is not None and ctx_mods.shape[1] != cfg.register_length + Lc:
        ctx_mods = ctx_mods[:, :cfg.register_length + Lc]
    if cfg.register_length > 0:
        context = torch.cat(
            [params.register.to(context.dtype).expand(B, -1, -1), context], dim=1)

    key_mask = build_decode_key_mask(mask, xt.shape[1], cfg.register_length)
    if ctx_mods is None:
        ctx_mods = precompute_context_mods(params, cfg)
    out = _trunk(params, cfg, context, xt, c, ctx_mods, key_mask=key_mask)
    return unpatchify(out, cfg.patch_size, cfg.out_ch, gh, gw)


def mmdit_cfg_inference(*args, **kwargs):
    raise NotImplementedError(
        "mmdit_cfg_inference (the unconditional branch with register tokens) "
        "is not ported yet: ROADMAP.md queue item 'remaining encoder modes / "
        "multires / DiT / DDPM / text encoders'")


def mmdit_cfg_batched(*args, **kwargs):
    raise NotImplementedError(
        "mmdit_cfg_batched is not ported yet: ROADMAP.md queue item "
        "'remaining encoder modes / multires / DiT / DDPM / text encoders'")


def mmdit_uncond_xonly(params: MMDiT, cfg: MMDiTConfig, x, t):
    """Unconditional CFG branch with the context stream removed: the
    sampler's uncond call is fully masked, masked context keys get weight
    exactly 0, and the final layer reads only the x stream, so only the
    x blocks run (sequence 768 -> 256 at 256 px). Integer timesteps
    clip(floor(1000 t), 0, 999), as the reference's cfg_inference."""
    if cfg.register_length != 0:
        raise NotImplementedError(
            "register tokens are unmasked context keys, so the x-only branch "
            "is invalid; mmdit_cfg_inference is not ported yet: ROADMAP.md "
            "queue item 'remaining encoder modes / multires / DiT / DDPM / "
            "text encoders'")
    xt, gh, gw = _embed_x(params, cfg, x)
    ti = torch.clamp(torch.floor(t * 1000.0), 0, 999).to(torch.int32)
    c = timestep_embedder_apply(params.t_embedder, ti).to(xt.dtype)
    for bp in params.joint_blocks:
        (q, k, v), inter = dismantled_pre_attention(bp.x_block, cfg, xt, c)
        attn = serving_attention(q, k, v)
        b, nh, L, d = attn.shape
        attn = attn.permute(0, 2, 1, 3).reshape(b, L, nh * d)
        xt = dismantled_post_attention(bp.x_block, attn, inter)
    out = final_layer_apply(params.final_layer, xt, c)
    return unpatchify(out, cfg.patch_size, cfg.out_ch, gh, gw)
