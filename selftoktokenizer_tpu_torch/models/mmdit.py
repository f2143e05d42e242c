"""MMDiT: the SD3-style joint-attention diffusion decoder, its one-step
mask-token renderer, the earlier standalone RenderDiT and the
multi-resolution MMDiT (counterpart of the reference ``models/mmdit.py``).

The modules own the weights under the reference checkpoint's names
(``joint_blocks.{i}.x_block.attn.qkv.weight``, the last joint block with a
pre-only context branch, ...); the functions, named as in the reference, do
the work. The joint attention of every block goes through
``ops.attention.serving_attention`` -> the CUDA kernel, for bf16 and fp32
alike (plain ``sdpa_key_mask`` with ``use_flash_attention=False``, the
reference's XLA route); the renderer's full mask is two key masks stacked
by row, so it takes two kernel calls per block (``renderer_apply``).
Every linear goes through ``ops.linear.linear_apply``, so a ``Q8Linear``
(int8 decode) takes the int8 kernel. The context stream's per-position
adaLN table depends only on the weights and is computed once
(``precompute_context_mods``).

Training: ``mmdit_apply`` takes the CFG condition drop (``drop_ids``) and a
conditioning vector ``y``, and with ``context_see_xt=False`` takes the
renderer's route (two key-masked attention calls a block). With
``cfg.use_checkpoint`` every joint block runs under
``torch.utils.checkpoint`` while gradients are recorded.

Options: qk-norm 'rms' or 'ln' (a per-head LayerNorm with weight and
bias); the context stream's adaLN from the per-sample conditioning
('t_emb'), from a per-position table ('pos_emb') or from both added
('pos_t_emb', whose table is the per-position embedding alone);
``sd3_cond_pooling`` 'last' / 'mean' (a pooled conditioning through
``y_embedder``, applied where the reference pools: the unconditional branch
and RenderDiT). The CFG branches: ``mmdit_cfg_inference`` (context zeros,
registers kept), ``mmdit_uncond_xonly`` (no registers: the context stream
dropped) and ``mmdit_cfg_batched`` (both branches in one 2B trunk). The
unconditional buffers ``uncond_y`` / ``uncond_c`` are read from the files
the config names (``load_uncond_buffers``) and set on the module as
non-persistent buffers (``set_uncond_buffers``). No path reads
``uncond_c``: the reference splices it into a renderer's unconditional
context in ``cfg_inference`` / ``cfg_batched``, which patch-embed the
noised latent, and a renderer has no patch embedder.

The multi-resolution MMDiT (``MMDiT(cfg, multires=True)``,
``mmdit_multires_apply``) adds a low-res context stream
(``context_block_low_res``) and a reconstruction stream (``rec_block``, a
clean low-res latent at t = 0 whose keys and values join the joint
attention). Its attention is plain ``sdpa`` under the full mask, with a
finite -1e30 bias for a masked key: a row with no active key gives the
uniform mean of its values, where the reference's -inf gives NaN.
"""

from __future__ import annotations

import dataclasses
import os
from typing import Optional

import numpy as np
import torch
import torch.nn.functional as F
import torch.utils.checkpoint
from torch import nn

from selftoktokenizer_tpu_torch.models.encoder import (
    LayerNormWeight, Mlp, PatchEmbed, RMSNormWeight, TimestepEmbedder, _merge_heads,
    mlp_apply, patch_embed_apply, timestep_embedder_apply)
from selftoktokenizer_tpu_torch.ops.attention import sdpa, sdpa_key_mask, serving_attention
from selftoktokenizer_tpu_torch.ops.linear import (
    linear, linear_apply, modulate, unpatchify)
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
    # the joint attention's route: the kernel router
    # (ops.attention.serving_attention), or with use_flash_attention=False
    # plain sdpa_key_mask, the reference's XLA attention. serving_attention
    # is kept so configs compare equal with the reference's: there it picks
    # bf16-score XLA attention or its kernel by key length on the bf16
    # route; the port takes the kernel at every length either way
    use_flash_attention: bool = True
    serving_attention: bool = True
    # recompute each joint block's activations in the backward
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


def _check_options(cfg: MMDiTConfig):
    if cfg.time_adaln not in ("pos_emb", "pos_t_emb", "t_emb"):
        raise ValueError(f"unknown time_adaln {cfg.time_adaln!r}")
    if cfg.qk_norm not in (None, "rms", "ln"):
        raise ValueError(f"unknown qk_norm {cfg.qk_norm!r}")
    if cfg.sd3_cond_pooling not in (None, "last", "mean"):
        raise ValueError(f"unknown sd3_cond_pooling {cfg.sd3_cond_pooling!r}")


# ---------------------------------------------------------------------------
# weight-owning modules (reference checkpoint names)
# ---------------------------------------------------------------------------

class _Attn(nn.Module):
    def __init__(self, cfg: MMDiTConfig, pre_only):
        super().__init__()
        D = cfg.hidden_size
        self.qkv = nn.Linear(D, 3 * D, bias=cfg.qkv_bias)
        norm = {"rms": RMSNormWeight, "ln": LayerNormWeight}.get(cfg.qk_norm)
        if norm is not None:
            self.ln_q = norm(D // cfg.num_heads)
            self.ln_k = norm(D // cfg.num_heads)
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
    """multires: also the low-res context stream's block (pre-only in the
    last block, like the context block) and the reconstruction stream's.

    Calling the block runs ``joint_block_apply`` on it (``forward``), which
    is how ``_trunk`` steps through the decoder: a block sharded by FSDP
    (``parallel.mesh.apply_fsdp``) gathers its weights around that call."""

    def __init__(self, cfg: MMDiTConfig, last=False, multires=False):
        super().__init__()
        pos = cfg.time_adaln in ("pos_emb", "pos_t_emb")
        self.context_block = DismantledBlock(cfg, pre_only=last, pos_embedder=pos)
        self.x_block = DismantledBlock(cfg)
        if multires:
            self.context_block_low_res = DismantledBlock(cfg, pre_only=last, pos_embedder=pos)
            self.rec_block = DismantledBlock(cfg)

    def forward(self, cfg: MMDiTConfig, context, x, c, pos_mods=None, key_mask=None, last=False,
                ctx_key_mask=None, own_mods=False, remat=False):
        """``joint_block_apply`` of this block. own_mods: pos_mods is the
        context block's own row of the adaLN table (``block_context_mods``),
        computed here from its weights. remat: recompute the block's
        activations in the backward (``torch.utils.checkpoint``)."""
        def fn(context, x):
            mods = pos_mods
            if own_mods:
                mods = block_context_mods(self.context_block, cfg)[:context.shape[1]]
                mods = mods.to(context.dtype)
            return joint_block_apply(self, cfg, context, x, c, pos_mods=mods,
                                     key_mask=key_mask, last=last, ctx_key_mask=ctx_key_mask)
        if remat:
            return torch.utils.checkpoint.checkpoint(fn, context, x, use_reentrant=False)
        return fn(context, x)


class FinalLayer(nn.Module):
    def __init__(self, cfg: MMDiTConfig):
        super().__init__()
        D = cfg.hidden_size
        self.linear = nn.Linear(D, cfg.patch_size ** 2 * cfg.out_ch)
        self.adaLN_modulation = nn.Sequential(nn.SiLU(), nn.Linear(D, 2 * D))


class MMDiT(nn.Module):
    """Weights of the decoder. ``joint_blocks[depth-1]`` is the last block,
    whose context branch is pre-only. A renderer (``cfg.renderer``) owns a
    learned ``mask_token`` [1, 1 or grid^2, D] and ``positional_embedding``
    [grid^2, D] in place of the patch embedder and its ``pos_embed``.
    ``multires`` adds the multi-resolution leaves: ``x_embedder_clean``,
    ``context_embedder_low_res`` and each joint block's
    ``context_block_low_res`` and ``rec_block``."""

    def __init__(self, cfg: MMDiTConfig, multires=False):
        super().__init__()
        _check_options(cfg)
        self.cfg = cfg
        D = cfg.hidden_size
        self.t_embedder = TimestepEmbedder(D)
        self.context_embedder = nn.Linear(cfg.encoder_hidden_size, cfg.context_dim)
        self.final_layer = FinalLayer(cfg)
        if cfg.renderer:
            grid = cfg.input_size // 2
            self.positional_embedding = nn.Parameter(torch.empty(grid * grid, D))
            self.mask_token = nn.Parameter(torch.empty(
                1, 1 if cfg.repeat_mask_token else grid * grid, D))
        else:
            self.x_embedder = PatchEmbed(cfg.patch_size, cfg.in_channels, D)
            self.pos_embed = nn.Parameter(torch.zeros(1, cfg.num_patches, D))
        if cfg.adm_in_channels is not None:
            # part of the checkpoint; pooled conditioning reads it
            self.y_embedder = TimestepEmbedder(D, dim_freq=cfg.adm_in_channels)
        base = 1000 + 8 * np.arange(cfg.K) if cfg.diti_positions else np.arange(cfg.K)
        # a sincos table at init, and trained like every other leaf
        self.context_pos_embed = nn.Parameter(torch.tensor(
            sincos_1d(cfg.context_dim, base.astype(np.float32)), dtype=torch.float32)[None])
        if cfg.register_length > 0:
            self.register = nn.Parameter(torch.empty(1, cfg.register_length, D))
        if multires:
            if cfg.renderer:
                raise ValueError("a renderer has no multi-resolution streams")
            self.x_embedder_clean = PatchEmbed(cfg.patch_size, cfg.in_channels, D)
            self.context_embedder_low_res = nn.Linear(cfg.encoder_hidden_size, cfg.context_dim)
        self.joint_blocks = nn.ModuleList(
            JointBlock(cfg, last=i == cfg.depth - 1, multires=multires)
            for i in range(cfg.depth))

    def set_uncond_buffers(self, buffers):
        """Set ``uncond_y`` / ``uncond_c`` (from ``load_uncond_buffers``) as
        buffers that move and cast with the module but stay out of its
        state dict, as they stay out of a reference checkpoint."""
        for name, t in buffers.items():
            self.register_buffer(name, t.to(self.t_embedder.mlp[0].weight.device),
                                 persistent=False)


def mmdit_from_state_dict(sd, cfg: MMDiTConfig) -> MMDiT:
    """A reference MMDiT state dict -> MMDiT on the CPU in fp32, loaded
    strictly; with the multi-resolution streams when the dict holds their
    leaves (``x_embedder_clean.*``)."""
    m = MMDiT(cfg, multires=any(k.startswith("x_embedder_clean.") for k in sd))
    m.load_state_dict({k: v.float() for k, v in sd.items()}, strict=True)
    return m


def load_uncond_buffers(cfg: MMDiTConfig):
    """The CFG unconditional buffers the config names: {'uncond_y': ...,
    'uncond_c': ...} for each of ``uncond_y_file`` / ``uncond_c_file`` that
    exists, read with ``torch.load(weights_only=True)`` onto the CPU in
    fp32 (an empty dict when neither does: the unconditional branch then
    takes no pooled y and zero context)."""
    out = {}
    for name, path in (("uncond_y", cfg.uncond_y_file), ("uncond_c", cfg.uncond_c_file)):
        if path and os.path.exists(path):
            out[name] = torch.load(path, map_location="cpu", weights_only=True).float()
    return out


# ---------------------------------------------------------------------------
# DismantledBlock
# ---------------------------------------------------------------------------

def _adaln(p, c):
    return linear_apply(p.adaLN_modulation[1], F.silu(c))


def _qkv_split(p: DismantledBlock, cfg: MMDiTConfig, x):
    """qkv linear + optional per-head q/k norm, flat [B,L,C] -> 3x[B,H,L,D].
    H is the heads the qkv weight holds: all of them, or this rank's under
    tensor parallelism (``parallel.tp`` orders its rows head-wise)."""
    B, L, C = x.shape
    hd = C // cfg.num_heads
    qkv = linear_apply(p.attn.qkv, x)
    qkv = qkv.reshape(B, L, 3, qkv.shape[-1] // (3 * hd), hd)
    q, k, v = qkv[:, :, 0], qkv[:, :, 1], qkv[:, :, 2]
    if cfg.qk_norm == "rms":
        q = rms_norm(q, p.attn.ln_q.weight)
        k = rms_norm(k, p.attn.ln_k.weight)
    elif cfg.qk_norm == "ln":
        q = layer_norm(q, p.attn.ln_q.weight, p.attn.ln_q.bias)
        k = layer_norm(k, p.attn.ln_k.weight, p.attn.ln_k.bias)
    return q.permute(0, 2, 1, 3), k.permute(0, 2, 1, 3), v.permute(0, 2, 1, 3)


def dismantled_pre_attention(p: DismantledBlock, cfg: MMDiTConfig, x, c,
                             pos_mods=None, pre_only=False):
    """pos_mods: the context block's row of the precomputed table, in
    'pos_emb' mode the modulations [L, 6*hidden], in 'pos_t_emb' mode the
    per-position embeddings [L, hidden], which are added to the per-sample
    conditioning c before the adaLN (modulations [B, L, 6*hidden]); None
    for the 't_emb' mode and the x stream (driven by c alone).
    Returns (q, k, v), intermediates."""
    if pre_only:
        shift_msa, scale_msa = torch.chunk(_adaln(p, c), 2, dim=-1)
        qkv = _qkv_split(p, cfg, modulate(layer_norm(x), shift_msa, scale_msa, 1))
        return qkv, None
    if pos_mods is not None and cfg.time_adaln == "pos_t_emb":
        mods = _adaln(p, c[:, None, :] + pos_mods[None, :x.shape[1]])
        shift_msa, scale_msa, gate_msa, shift_mlp, scale_mlp, gate_mlp = \
            torch.chunk(mods, 6, dim=-1)
        qkv = _qkv_split(p, cfg, modulate(layer_norm(x), shift_msa, scale_msa))
        return qkv, (x, gate_msa, shift_mlp, scale_mlp, gate_mlp, None)
    if pos_mods is not None:
        mods, axis = pos_mods, 0
    else:
        mods, axis = _adaln(p, c), 1
    shift_msa, scale_msa, gate_msa, shift_mlp, scale_mlp, gate_mlp = \
        torch.chunk(mods, 6, dim=-1)
    qkv = _qkv_split(p, cfg, modulate(layer_norm(x), shift_msa, scale_msa, axis))
    return qkv, (x, gate_msa, shift_mlp, scale_mlp, gate_mlp, axis)


def dismantled_post_attention(p: DismantledBlock, attn_out, inter):
    """attn_out: [B, L, C]. axis None: the mods are already [B, L, C]."""
    x, gate_msa, shift_mlp, scale_mlp, gate_mlp, axis = inter
    if axis is not None:
        gate_msa, gate_mlp = gate_msa.unsqueeze(axis), gate_mlp.unsqueeze(axis)
    x = x + gate_msa * linear_apply(p.attn.proj, attn_out)
    x = x + gate_mlp * mlp_apply(
        p.mlp, modulate(layer_norm(x), shift_mlp, scale_mlp, 0 if axis is None else axis))
    return x


def _attention(cfg: MMDiTConfig, q, k, v, key_mask=None):
    """The decoder's attention: through the kernel router, or with
    ``cfg.use_flash_attention`` off through plain ``sdpa_key_mask`` (its
    autograd backward in training)."""
    if cfg.use_flash_attention:
        return serving_attention(q, k, v, key_mask)
    return sdpa_key_mask(q, k, v, key_mask)


def joint_block_apply(bp: JointBlock, cfg: MMDiTConfig, context, x, c,
                      pos_mods=None, key_mask=None, last=False, ctx_key_mask=None):
    """One JointBlock: separate pre-attention per stream, one concatenated
    attention (context keys first), separate post-attention.

    key_mask [B, Lc+Lx] masks the keys of every row. With ctx_key_mask
    [B, Lc] the context rows attend over the context keys only, under that
    mask (context_see_xt=False, the renderer's mask), and the x rows over all
    keys under key_mask: two attention calls instead of one.
    Returns (context', x')."""
    ctx_qkv, ctx_inter = dismantled_pre_attention(
        bp.context_block, cfg, context, c,
        pos_mods=None if last else pos_mods, pre_only=last)
    x_qkv, x_inter = dismantled_pre_attention(bp.x_block, cfg, x, c)

    k = torch.cat([ctx_qkv[1], x_qkv[1]], dim=2)
    v = torch.cat([ctx_qkv[2], x_qkv[2]], dim=2)
    if ctx_key_mask is None:
        q = torch.cat([ctx_qkv[0], x_qkv[0]], dim=2)
        attn = _merge_heads(_attention(cfg, q, k, v, key_mask))
        Lc = context.shape[1]
        ctx_attn, x_attn = attn[:, :Lc], attn[:, Lc:]
    else:
        ctx_attn = _merge_heads(_attention(cfg, *ctx_qkv, ctx_key_mask))
        x_attn = _merge_heads(_attention(cfg, x_qkv[0], k, v, key_mask))

    new_ctx = None if last else dismantled_post_attention(
        bp.context_block, ctx_attn, ctx_inter)
    new_x = dismantled_post_attention(bp.x_block, x_attn, x_inter)
    return new_ctx, new_x


def precompute_context_mods(params: MMDiT, cfg: MMDiTConfig, length=None,
                            block_key="context_block"):
    """Context adaLN table over register_length + K positions (or
    ``length``), a function of the weights only: in 'pos_emb' mode the
    modulations [depth-1, L, 6*hidden] (hoisting them removes t_embedder +
    adaLN of every context block from the 50-step decode loop), in
    'pos_t_emb' mode the per-position embeddings [depth-1, L, hidden] (the
    adaLN then depends on the per-sample conditioning); None in 't_emb'
    mode. block_key: the stream's block, 'context_block_low_res' for the
    multi-resolution low-res context."""
    if cfg.time_adaln not in ("pos_emb", "pos_t_emb"):
        return None
    return torch.stack([block_context_mods(getattr(bp, block_key), cfg, length)
                        for bp in list(params.joint_blocks)[:-1]])


def block_context_mods(blk: DismantledBlock, cfg: MMDiTConfig, length=None):
    """One context block's row of ``precompute_context_mods``: [L, 6*hidden]
    ('pos_emb') or [L, hidden] ('pos_t_emb')."""
    L = length if length is not None else cfg.register_length + cfg.K
    base = 1000 + 8 * np.arange(L) if cfg.diti_positions else np.arange(L)
    positions = torch.as_tensor(base, dtype=torch.float32,
                                device=blk.adaLN_modulation[1].bias.device)
    t_emb = timestep_embedder_apply(blk.t_embedder, positions)
    return t_emb if cfg.time_adaln == "pos_t_emb" else _adaln(blk, t_emb)


def final_layer_apply(p: FinalLayer, x, c):
    shift, scale = torch.chunk(_adaln(p, c), 2, dim=-1)
    return linear_apply(p.linear, modulate(layer_norm(x), shift, scale, 1))


# ---------------------------------------------------------------------------
# MMDiT
# ---------------------------------------------------------------------------

def _trunk(params: MMDiT, cfg: MMDiTConfig, context, x, c, ctx_mods, key_mask=None,
           ctx_key_mask=None):
    """depth-1 joint blocks + the final pre-only block + final layer, each
    block called as a module. ctx_mods None in a 'pos_emb' / 'pos_t_emb'
    mode: each block computes its row of the table itself (the values of
    ``precompute_context_mods``)."""
    own = ctx_mods is None and cfg.time_adaln in ("pos_emb", "pos_t_emb")
    if ctx_mods is not None:
        ctx_mods = ctx_mods.to(context.dtype)
    remat = cfg.use_checkpoint and torch.is_grad_enabled()
    blocks = list(params.joint_blocks)
    for i, bp in enumerate(blocks[:-1]):
        context, x = bp(cfg, context, x, c, pos_mods=None if ctx_mods is None else ctx_mods[i],
                        key_mask=key_mask, ctx_key_mask=ctx_key_mask, own_mods=own, remat=remat)
    _, x = blocks[-1](cfg, context, x, c, key_mask=key_mask, last=True,
                      ctx_key_mask=ctx_key_mask, remat=remat)
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
                mask=None, y=None, context_see_xt=True, ctx_mods=None, drop_ids=None):
    """MMDiT forward.

    x: NHWC noised latents [B,h,w,C]; t: [B] in [0,1] (scaled x1000 inside);
    encoder_hidden_states: [B,Lc,encoder_hidden_size], Lc a prefix of K;
    mask: [B,Lc] bool; y: optional [B, hidden] added to the conditioning;
    drop_ids: optional [B] bool, the CFG condition drop of training (a
    dropped sample's context and mask are zeroed unless t = 1). With
    context_see_xt=False the context rows attend over the context keys only
    (the reference's full [B,1,L,L] mask): two key-masked calls a block, as
    the renderer makes; a context row with every context key masked gives
    the uniform mean of its keys where the full mask would give NaN.
    Returns the NHWC velocity field."""
    B = x.shape[0]
    xt, gh, gw = _embed_x(params, cfg, x)
    c = timestep_embedder_apply(params.t_embedder, t * 1000.0).to(xt.dtype)

    Lc = encoder_hidden_states.shape[1]
    context = linear_apply(params.context_embedder, encoder_hidden_states)
    context = (context + params.context_pos_embed[:, :Lc]).to(xt.dtype)

    if mask is None:
        mask = torch.ones((B, Lc), dtype=torch.bool, device=x.device)
    if ctx_mods is not None and ctx_mods.shape[1] != cfg.register_length + Lc:
        ctx_mods = ctx_mods[:, :cfg.register_length + Lc]
    if drop_ids is not None:
        drop = drop_ids & (t * 1000.0 != 1000.0)
        context = torch.where(drop[:, None, None], torch.zeros_like(context), context)
        mask = mask & ~drop[:, None]
    if y is not None:
        c = c + y
    context = _with_registers(params, cfg, context)

    key_mask = build_decode_key_mask(mask, xt.shape[1], cfg.register_length)
    ctx_key_mask = None if context_see_xt else build_decode_key_mask(
        mask, 0, cfg.register_length)
    out = _trunk(params, cfg, context, xt, c, ctx_mods, key_mask=key_mask,
                 ctx_key_mask=ctx_key_mask)
    return unpatchify(out, cfg.patch_size, cfg.out_ch, gh, gw)


def _pool_y(params: MMDiT, cfg: MMDiTConfig, encoder_hidden_states, mask):
    """sd3_cond_pooling: the pooled conditioning [B, hidden] through
    ``y_embedder``, or None without pooling. 'last' takes each row's last
    active token. 'mean' keeps the reference's quirk: the sum runs over
    every token while the divisor counts the active ones, a true masked
    mean only when the hidden states are already zero where the mask is."""
    if cfg.sd3_cond_pooling == "last":
        last = torch.sum(mask, dim=-1).long() - 1
        pooled = encoder_hidden_states[torch.arange(mask.shape[0], device=mask.device), last]
    elif cfg.sd3_cond_pooling == "mean":
        pooled = (torch.sum(encoder_hidden_states, dim=1)
                  / torch.sum(mask, dim=-1, keepdim=True).to(encoder_hidden_states.dtype))
    else:
        return None
    h = linear_apply(params.y_embedder.mlp[0], pooled)
    return linear_apply(params.y_embedder.mlp[2], F.silu(h))


def _timestep_int(params: MMDiT, t, dtype):
    """The unconditional branch's conditioning: the embedding of the
    integer timesteps clip(floor(1000 t), 0, 999)."""
    ti = torch.clamp(torch.floor(t * 1000.0), 0, 999).to(torch.int32)
    return timestep_embedder_apply(params.t_embedder, ti).to(dtype)


def _uncond_c(params: MMDiT, cfg: MMDiTConfig, t, dtype):
    """The conditioning of an unconditional branch without context: the
    integer timesteps' embedding, plus ``uncond_y`` under pooling when it
    is loaded."""
    c = _timestep_int(params, t, dtype)
    uy = getattr(params, "uncond_y", None)
    if cfg.sd3_cond_pooling and uy is not None:
        c = c + uy.to(c.dtype)
    return c


def _with_registers(params: MMDiT, cfg: MMDiTConfig, context):
    if cfg.register_length == 0:
        return context
    B = context.shape[0]
    return torch.cat([params.register.to(context.dtype).expand(B, -1, -1), context], dim=1)


def mmdit_cfg_inference(params: MMDiT, cfg: MMDiTConfig, x, t, encoder_hidden_states,
                        mask=None, ctx_mods=None):
    """The reference's ``cfg_inference``, the unconditional CFG branch that
    keeps the context stream: with encoder_hidden_states None the context
    is zeros and ``uncond_y`` joins the conditioning under pooling; otherwise the embedded context,
    without ``context_pos_embed``, and its pooled y. Integer timesteps
    floor(1000 t). Register tokens are prepended and their keys stay
    active, so this is the branch for a decoder with registers. mask: [B, L]
    over the context rows (all active when None). Returns the NHWC
    velocity field."""
    B = x.shape[0]
    xt, gh, gw = _embed_x(params, cfg, x)
    if encoder_hidden_states is None:
        c = _uncond_c(params, cfg, t, xt.dtype)
        context = torch.zeros((B, cfg.K, cfg.hidden_size), dtype=xt.dtype, device=x.device)
    else:
        c = _timestep_int(params, t, xt.dtype)
        if cfg.sd3_cond_pooling:
            pool_mask = mask if mask is not None else torch.ones(
                encoder_hidden_states.shape[:2], dtype=torch.bool, device=x.device)
            c = c + _pool_y(params, cfg, encoder_hidden_states, pool_mask).to(c.dtype)
        context = linear_apply(params.context_embedder, encoder_hidden_states).to(xt.dtype)
    if mask is None:
        mask = torch.ones((B, context.shape[1]), dtype=torch.bool, device=x.device)
    context = _with_registers(params, cfg, context)
    if ctx_mods is None:
        ctx_mods = precompute_context_mods(params, cfg)
    if ctx_mods is not None and ctx_mods.shape[1] != context.shape[1]:
        ctx_mods = ctx_mods[:, :context.shape[1]]
    key_mask = build_decode_key_mask(mask, xt.shape[1], cfg.register_length)
    out = _trunk(params, cfg, context, xt, c, ctx_mods, key_mask=key_mask)
    return unpatchify(out, cfg.patch_size, cfg.out_ch, gh, gw)


def mmdit_cfg_batched(params: MMDiT, cfg: MMDiTConfig, x, t, encoder_hidden_states, mask,
                      ctx_mods=None):
    """Both CFG branches in one trunk over a 2B batch: rows [0, B) are the
    conditional pass (``mmdit_apply`` with context_see_xt, which never
    pools), rows [B, 2B) the unconditional one (``mmdit_cfg_inference``
    with every context key masked: zero context, or a renderer's
    ``uncond_c``, integer timesteps, ``uncond_y`` under pooling). The
    branches differ only in data, so each layer's weights are read once a
    step. No register tokens (the unconditional branch would need them
    active). Returns (v_cond, v_uncond)."""
    if cfg.register_length != 0:
        raise ValueError("mmdit_cfg_batched takes no register tokens: use "
                         "mmdit_apply and mmdit_cfg_inference")
    B = x.shape[0]
    xt, gh, gw = _embed_x(params, cfg, x)
    c_c = timestep_embedder_apply(params.t_embedder, t * 1000.0).to(xt.dtype)
    c_u = _uncond_c(params, cfg, t, xt.dtype)
    Lc = encoder_hidden_states.shape[1]
    ctx_c = linear_apply(params.context_embedder, encoder_hidden_states)
    ctx_c = (ctx_c + params.context_pos_embed[:, :Lc]).to(xt.dtype)
    ctx_u = torch.zeros((B, Lc, cfg.hidden_size), dtype=xt.dtype, device=x.device)
    mask2 = torch.cat([mask.bool(), torch.zeros_like(mask, dtype=torch.bool)], dim=0)
    key_mask = build_decode_key_mask(mask2, xt.shape[1])
    if ctx_mods is None:
        ctx_mods = precompute_context_mods(params, cfg)
    if ctx_mods is not None and ctx_mods.shape[1] != Lc:
        ctx_mods = ctx_mods[:, :Lc]
    out = _trunk(params, cfg, torch.cat([ctx_c, ctx_u]), torch.cat([xt, xt]),
                 torch.cat([c_c, c_u]), ctx_mods, key_mask=key_mask)
    v = unpatchify(out, cfg.patch_size, cfg.out_ch, gh, gw)
    return v[:B], v[B:]


def mmdit_uncond_xonly(params: MMDiT, cfg: MMDiTConfig, x, t):
    """Unconditional CFG branch with the context stream removed: the
    sampler's uncond call is fully masked, masked context keys get weight
    exactly 0, and the final layer reads only the x stream, so only the
    x blocks run (sequence 768 -> 256 at 256 px). Integer timesteps
    clip(floor(1000 t), 0, 999), and ``uncond_y`` under pooling, as the
    reference's cfg_inference."""
    if cfg.register_length != 0:
        raise ValueError(
            "register tokens are unmasked context keys, so the x-only branch "
            "is invalid: use mmdit_cfg_inference")
    xt, gh, gw = _embed_x(params, cfg, x)
    c = _uncond_c(params, cfg, t, xt.dtype)
    for bp in params.joint_blocks:
        qkv, inter = dismantled_pre_attention(bp.x_block, cfg, xt, c)
        xt = dismantled_post_attention(bp.x_block, _merge_heads(_attention(cfg, *qkv)),
                                       inter)
    out = final_layer_apply(params.final_layer, xt, c)
    return unpatchify(out, cfg.patch_size, cfg.out_ch, gh, gw)


def renderdit_apply(params: MMDiT, cfg: MMDiTConfig, encoder_hidden_states, mask=None,
                    x_mask=None, hw=(32, 32), ctx_mods=None):
    """The reference's RenderDiT (the earlier standalone renderer): the x
    stream is the learned mask token over a fixed 16 x 16 grid at t = 1000,
    the conditioning takes the pooled y under pooling, and every row sees
    the same keys [registers | tokens under mask | mask tokens under
    x_mask] (the context rows see the mask-token stream, unlike
    MMDiT_Renderer's): one attention kernel call a block.
    encoder_hidden_states: [B, K, encoder_hidden_size]; mask: [B, K] bool;
    hw: the latent's height and width. Returns NHWC latents."""
    B = encoder_hidden_states.shape[0]
    grid = 16    # fixed in the reference
    tok = params.mask_token
    x = tok.expand(B, grid * grid, cfg.hidden_size) + params.positional_embedding.to(tok.dtype)
    t1000 = torch.full((B,), 1000.0, dtype=torch.float32, device=x.device)
    c = timestep_embedder_apply(params.t_embedder, t1000).to(x.dtype)
    if mask is None:
        mask = torch.ones((B, cfg.K), dtype=torch.bool, device=x.device)
    if cfg.sd3_cond_pooling:
        c = c + _pool_y(params, cfg, encoder_hidden_states, mask).to(c.dtype)
    context = linear_apply(params.context_embedder, encoder_hidden_states)
    context = _with_registers(params, cfg, (context + params.context_pos_embed).to(x.dtype))
    if x_mask is None:
        x_mask = torch.ones((B, x.shape[1]), dtype=torch.bool, device=x.device)
    key_mask = torch.cat([build_decode_key_mask(mask, 0, cfg.register_length),
                          x_mask.bool()], dim=1)
    if ctx_mods is None:
        ctx_mods = precompute_context_mods(params, cfg)
    out = _trunk(params, cfg, context, x, c, ctx_mods, key_mask=key_mask)
    p = cfg.patch_size
    return unpatchify(out, p, cfg.out_ch, hw[0] // p, hw[1] // p)


def renderer_apply(params: MMDiT, cfg: MMDiTConfig, encoder_hidden_states, mask=None,
                   ctx_mods=None):
    """MMDiT_Renderer forward (the reference's ``renderer_apply``): the x
    stream is the learned mask token over the latent grid at the fixed
    t = 1000, and one pass gives the predicted clean latent, NHWC
    [B, input, input, C]. encoder_hidden_states: [B, K, encoder_hidden_size];
    mask: optional [B, K] bool token mask.

    The context and the timestep embedding are computed in the type of
    encoder_hidden_states (fp32 from the pipeline) and only then cast to the
    decoder's type, as in the reference.

    The reference's mask is the full [B,1,L,L] one with
    context_see_xt=False: context rows attend over [registers, tokens], x
    rows over every key. That is two key masks stacked by row, so each block
    makes two calls of the attention kernel (48 at depth 24). It equals the
    reference for every row with at least one active key. A context row
    whose registers and tokens are all masked would be NaN there (a softmax
    over -inf only) and the uniform mean of its keys here; the pipeline
    never builds one (its renderer call masks no token)."""
    B = encoder_hidden_states.shape[0]
    grid = cfg.input_size // 2
    tok = params.mask_token
    x = tok.expand(B, grid * grid, cfg.hidden_size) + params.positional_embedding.to(tok.dtype)
    t1000 = torch.full((B,), 1000.0, dtype=torch.float32, device=x.device)
    c = timestep_embedder_apply(params.t_embedder, t1000).to(x.dtype)
    context = linear_apply(params.context_embedder, encoder_hidden_states)
    context = _with_registers(params, cfg, (context + params.context_pos_embed).to(x.dtype))
    if mask is None:
        mask = torch.ones((B, cfg.K), dtype=torch.bool, device=x.device)
    ctx_key_mask = build_decode_key_mask(mask, 0, cfg.register_length)
    key_mask = build_decode_key_mask(mask, x.shape[1], cfg.register_length)
    if ctx_mods is None:
        ctx_mods = precompute_context_mods(params, cfg)
    out = _trunk(params, cfg, context, x, c, ctx_mods, key_mask=key_mask,
                 ctx_key_mask=ctx_key_mask)
    return unpatchify(out, cfg.patch_size, cfg.out_ch, grid, grid)


# ---------------------------------------------------------------------------
# multi-resolution MMDiT
# ---------------------------------------------------------------------------

def joint_block_apply_mr(bp: JointBlock, cfg: MMDiTConfig, context, x, c, c0, ctx_lowres=None,
                         rec=None, pos_mods=None, lowres_pos_mods=None, mask=None, last=False):
    """A JointBlock with the low-res context (a third query stream) and the
    reconstruction stream: ``rec_block`` runs full self-attention over rec
    at t = 0 (c0) and hands its keys and values to the joint attention,
    whose rows are [context | x | low-res] and keys [context | x | low-res |
    rec]. mask: the additive bias [B, 1, Lq, Lk]. Returns (context', x',
    low-res', rec'), the streams of the last block None but x."""
    ctx_qkv, ctx_inter = dismantled_pre_attention(
        bp.context_block, cfg, context, c, pos_mods=None if last else pos_mods, pre_only=last)
    x_qkv, x_inter = dismantled_pre_attention(bp.x_block, cfg, x, c)
    qs, ks, vs = [ctx_qkv[0], x_qkv[0]], [ctx_qkv[1], x_qkv[1]], [ctx_qkv[2], x_qkv[2]]
    if ctx_lowres is not None:
        lr_qkv, lr_inter = dismantled_pre_attention(
            bp.context_block_low_res, cfg, ctx_lowres, c,
            pos_mods=None if last else lowres_pos_mods, pre_only=last)
        qs.append(lr_qkv[0])
        ks.append(lr_qkv[1])
        vs.append(lr_qkv[2])
    rec_out = None
    if rec is not None:
        r_qkv, r_inter = dismantled_pre_attention(bp.rec_block, cfg, rec, c0)
        if not last:
            rec_out = dismantled_post_attention(bp.rec_block, _merge_heads(sdpa(*r_qkv)), r_inter)
        ks.append(r_qkv[1])
        vs.append(r_qkv[2])
    attn = _merge_heads(sdpa(torch.cat(qs, dim=2), torch.cat(ks, dim=2), torch.cat(vs, dim=2),
                             mask=mask))
    Lc, Lx = context.shape[1], x.shape[1]
    new_x = dismantled_post_attention(bp.x_block, attn[:, Lc:Lc + Lx], x_inter)
    if last:
        return None, new_x, None, None
    new_ctx = dismantled_post_attention(bp.context_block, attn[:, :Lc], ctx_inter)
    new_lr = None
    if ctx_lowres is not None:
        new_lr = dismantled_post_attention(
            bp.context_block_low_res, attn[:, Lc + Lx:Lc + Lx + ctx_lowres.shape[1]], lr_inter)
    return new_ctx, new_x, new_lr, rec_out


def build_multires_mask(token_mask, n_x, cmask, rec_mask, context_see_xt, context_see_rec):
    """The full boolean mask [B, 1, Lq, Lk]: rows (context | x | low-res),
    columns (tokens | x | low-res | rec). The context and low-res rows see x
    under context_see_xt and rec under context_see_rec; the x rows see
    every active key."""
    B, K = token_mask.shape
    Kl = cmask.shape[1]
    dev = token_mask.device
    ones_x = torch.ones((B, n_x), dtype=torch.bool, device=dev)
    tok, cm = token_mask.bool(), cmask.bool()
    ctx_cols = [tok, ones_x if context_see_xt else torch.zeros_like(ones_x), cm]
    img_cols = [tok, ones_x, cm]
    if rec_mask is not None:
        rm = rec_mask.bool()
        ctx_cols.append(rm if context_see_rec else torch.zeros_like(rm))
        img_cols.append(rm)
    ctx_cols, img_cols = torch.cat(ctx_cols, dim=1), torch.cat(img_cols, dim=1)
    Lk = ctx_cols.shape[1]
    rows = torch.cat([ctx_cols[:, None].expand(B, K, Lk), img_cols[:, None].expand(B, n_x, Lk),
                      ctx_cols[:, None].expand(B, Kl, Lk)], dim=1)
    return rows[:, None]


def mmdit_multires_apply(params: MMDiT, cfg: MMDiTConfig, x, t, encoder_hidden_states,
                         hidden_states_low_res, low_res_latent, mask=None,
                         context_lowres_mask=None, context_see_xt=False, context_see_rec=False,
                         y=None):
    """The multi-resolution MMDiT forward. x: NHWC noised latents; t: [B]
    in [0, 1]; encoder_hidden_states [B, K, encoder_hidden_size] and mask
    [B, K]; hidden_states_low_res [B, Kl, encoder_hidden_size] (Kl <= K) and
    context_lowres_mask [B, Kl]; low_res_latent: the clean NHWC low-res
    latent of the reconstruction stream (every rec key active); y: an
    optional [B, hidden] conditioning. Activations take x's type. Returns
    the NHWC velocity field."""
    if cfg.time_adaln == "pos_t_emb":
        raise NotImplementedError(
            "pos_t_emb is not supported on the multires path (no reference "
            "config combines them)")
    B = x.shape[0]
    xt, gh, gw = _embed_x(params, cfg, x)
    lh, lw = low_res_latent.shape[1] // cfg.patch_size, low_res_latent.shape[2] // cfg.patch_size
    rec = patch_embed_apply(params.x_embedder_clean, low_res_latent.to(xt.dtype))
    rec = rec + crop_pos_embed(params.pos_embed, cfg.pos_embed_max_size, lh, lw).to(rec.dtype)
    rec_mask = torch.ones((B, rec.shape[1]), dtype=torch.bool, device=x.device)

    t1000 = t * 1000.0
    c = timestep_embedder_apply(params.t_embedder, t1000).to(xt.dtype)
    c0 = timestep_embedder_apply(params.t_embedder, torch.zeros_like(t1000)).to(xt.dtype)
    context = linear_apply(params.context_embedder, encoder_hidden_states)
    context = (context + params.context_pos_embed).to(xt.dtype)
    Kl = hidden_states_low_res.shape[1]
    ctx_lowres = linear_apply(params.context_embedder_low_res, hidden_states_low_res)
    ctx_lowres = (ctx_lowres + params.context_pos_embed[:, :Kl]).to(xt.dtype)
    if y is not None:
        c = c + y
    if mask is None:
        mask = torch.ones((B, cfg.K), dtype=torch.bool, device=x.device)
    cmask = context_lowres_mask if context_lowres_mask is not None else \
        torch.ones((B, Kl), dtype=torch.bool, device=x.device)
    full = build_multires_mask(mask, xt.shape[1], cmask, rec_mask, context_see_xt,
                               context_see_rec)
    bias = torch.where(full, 0.0, -1e30).to(torch.float32)

    ctx_mods = lowres_mods = None
    if cfg.time_adaln == "pos_emb":
        ctx_mods = precompute_context_mods(params, cfg)[:, :context.shape[1]].to(xt.dtype)
        lowres_mods = precompute_context_mods(params, cfg, length=Kl,
                                              block_key="context_block_low_res").to(xt.dtype)
    blocks = list(params.joint_blocks)
    for i, bp in enumerate(blocks[:-1]):
        context, xt, ctx_lowres, rec = joint_block_apply_mr(
            bp, cfg, context, xt, c, c0, ctx_lowres=ctx_lowres, rec=rec,
            pos_mods=None if ctx_mods is None else ctx_mods[i],
            lowres_pos_mods=None if lowres_mods is None else lowres_mods[i], mask=bias)
    _, xt, _, _ = joint_block_apply_mr(blocks[-1], cfg, context, xt, c, c0,
                                       ctx_lowres=ctx_lowres, rec=rec, mask=bias, last=True)
    out = final_layer_apply(params.final_layer, xt, c)
    return unpatchify(out, cfg.patch_size, cfg.out_ch, gh, gw)
