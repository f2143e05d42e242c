"""The class-conditional DiT (the DiT-XL/L/B/S family) and the reference's
two DiT block variants (counterpart of the reference ``models/dit.py``).

The modules own the weights under the reference checkpoint's names
(``blocks.{i}.attn.qkv.weight``, ``y_embedder.embedding_table.weight``,
``final_layer.adaLN_modulation.1.weight`` ...); the functions, named as in
the reference, do the work. Feature maps are NHWC, so a learned sigma is
the last axis's second half. Every attention is plain fp32-softmax
``sdpa``: the head dim is 72 at XL (1152 / 16), which the attention kernel
does not take.
"""

from __future__ import annotations

import dataclasses

import torch
import torch.nn.functional as F
from torch import nn

from selftoktokenizer_tpu_torch.models.encoder import (
    CrossAttention, DualAttention, EncoderConfig, Mlp, PatchEmbed, TimestepEmbedder,
    ViTAttention, cross_attention_apply, dual_attention_apply, mlp_apply, patch_embed_apply,
    timestep_embedder_apply, vit_attention_apply)
from selftoktokenizer_tpu_torch.ops.linear import linear, modulate, unpatchify
from selftoktokenizer_tpu_torch.ops.norms import layer_norm
from selftoktokenizer_tpu_torch.ops.posembed import sincos_2d


@dataclasses.dataclass
class DiTConfig:
    input_size: int = 32
    patch_size: int = 2
    in_channels: int = 4
    hidden_size: int = 1152
    depth: int = 28
    num_heads: int = 16
    mlp_ratio: float = 4.0
    class_dropout_prob: float = 0.1
    num_classes: int = 1000
    learn_sigma: bool = True

    @property
    def out_channels(self):
        return self.in_channels * 2 if self.learn_sigma else self.in_channels

    @property
    def grid(self):
        return self.input_size // self.patch_size


DIT_CONFIGS = {
    "DiT-XL/2": dict(depth=28, hidden_size=1152, patch_size=2, num_heads=16),
    "DiT-XL/4": dict(depth=28, hidden_size=1152, patch_size=4, num_heads=16),
    "DiT-XL/8": dict(depth=28, hidden_size=1152, patch_size=8, num_heads=16),
    "DiT-L/2": dict(depth=24, hidden_size=1024, patch_size=2, num_heads=16),
    "DiT-L/4": dict(depth=24, hidden_size=1024, patch_size=4, num_heads=16),
    "DiT-L/8": dict(depth=24, hidden_size=1024, patch_size=8, num_heads=16),
    "DiT-B/2": dict(depth=12, hidden_size=768, patch_size=2, num_heads=12),
    "DiT-B/4": dict(depth=12, hidden_size=768, patch_size=4, num_heads=12),
    "DiT-B/8": dict(depth=12, hidden_size=768, patch_size=8, num_heads=12),
    "DiT-S/2": dict(depth=12, hidden_size=384, patch_size=2, num_heads=6),
    "DiT-S/4": dict(depth=12, hidden_size=384, patch_size=4, num_heads=6),
    "DiT-S/8": dict(depth=12, hidden_size=384, patch_size=8, num_heads=6),
}


def _adaln(seq, c):
    lin = seq[1]
    return linear(F.silu(c), lin.weight, lin.bias)


# ---------------------------------------------------------------------------
# weight-owning modules (reference checkpoint names)
# ---------------------------------------------------------------------------

class DiTBlock(nn.Module):
    def __init__(self, hidden, num_heads, mlp_ratio=4.0):
        super().__init__()
        self.attn = ViTAttention(hidden)
        self.mlp = Mlp(hidden, int(hidden * mlp_ratio))
        self.adaLN_modulation = nn.Sequential(nn.SiLU(), nn.Linear(hidden, 6 * hidden))


class LabelEmbedder(nn.Module):
    """One row per class, and a null-class row (index num_classes) when
    the label dropout of classifier-free guidance is on."""

    def __init__(self, num_classes, hidden, dropout_prob):
        super().__init__()
        self.embedding_table = nn.Embedding(num_classes + int(dropout_prob > 0), hidden)


class DiTFinalLayer(nn.Module):
    def __init__(self, hidden, out):
        super().__init__()
        self.linear = nn.Linear(hidden, out)
        self.adaLN_modulation = nn.Sequential(nn.SiLU(), nn.Linear(hidden, 2 * hidden))


class DiT(nn.Module):
    def __init__(self, cfg: DiTConfig):
        super().__init__()
        self.cfg = cfg
        D = cfg.hidden_size
        self.x_embedder = PatchEmbed(cfg.patch_size, cfg.in_channels, D)
        # a sincos table at init; a leaf of the parameter tree like the others
        self.pos_embed = nn.Parameter(torch.tensor(sincos_2d(D, cfg.grid),
                                                   dtype=torch.float32)[None])
        self.t_embedder = TimestepEmbedder(D)
        self.y_embedder = LabelEmbedder(cfg.num_classes, D, cfg.class_dropout_prob)
        self.blocks = nn.ModuleList(DiTBlock(D, cfg.num_heads, cfg.mlp_ratio)
                                    for _ in range(cfg.depth))
        self.final_layer = DiTFinalLayer(D, cfg.patch_size ** 2 * cfg.out_channels)


# ---------------------------------------------------------------------------
# DiT
# ---------------------------------------------------------------------------

def dit_block_apply(p: DiTBlock, cfg: DiTConfig, x, c):
    """The adaLN-Zero DiT block."""
    shift_msa, scale_msa, gate_msa, shift_mlp, scale_mlp, gate_mlp = \
        torch.chunk(_adaln(p.adaLN_modulation, c), 6, dim=-1)
    x = x + gate_msa[:, None] * vit_attention_apply(
        p.attn, cfg.num_heads, modulate(layer_norm(x), shift_msa, scale_msa))
    return x + gate_mlp[:, None] * mlp_apply(p.mlp, modulate(layer_norm(x), shift_mlp, scale_mlp))


def label_embed(p: LabelEmbedder, cfg: DiTConfig, y, train=False, rng=None,
                force_drop_ids=None):
    """Class embeddings with the CFG label drop: force_drop_ids == 1 (or,
    in training with a torch.Generator rng, a uniform draw under the
    dropout probability) swaps the label for the null class."""
    if force_drop_ids is not None:
        y = torch.where(force_drop_ids == 1, cfg.num_classes, y)
    elif train and cfg.class_dropout_prob > 0 and rng is not None:
        drop = torch.rand(y.shape, generator=rng, device=rng.device).to(y.device) \
            < cfg.class_dropout_prob
        y = torch.where(drop, cfg.num_classes, y)
    return p.embedding_table.weight[y]


def dit_apply(params: DiT, cfg: DiTConfig, x, t, y, train=False, rng=None,
              force_drop_ids=None):
    """x: NHWC [B,H,W,C]; t: [B] timesteps; y: [B] int labels. Returns the
    NHWC output, 2C channels with a learned sigma."""
    xt = patch_embed_apply(params.x_embedder, x)
    xt = xt + params.pos_embed.to(xt.dtype)
    c = timestep_embedder_apply(params.t_embedder, t)
    c = (c + label_embed(params.y_embedder, cfg, y, train, rng, force_drop_ids)).to(xt.dtype)
    for bp in params.blocks:
        xt = dit_block_apply(bp, cfg, xt, c)
    shift, scale = torch.chunk(_adaln(params.final_layer.adaLN_modulation, c), 2, dim=-1)
    fl = params.final_layer.linear
    xt = linear(modulate(layer_norm(xt), shift, scale), fl.weight, fl.bias)
    return unpatchify(xt, cfg.patch_size, cfg.out_channels, cfg.grid, cfg.grid)


def dit_forward_with_cfg(params: DiT, cfg: DiTConfig, x, t, y, cfg_scale):
    """The CFG-batched forward: the first half of the batch conditional,
    the second unconditional (y carries the null class there); guidance on
    the first 3 channels only, as the reference does, the rest passed
    through."""
    half = x[: x.shape[0] // 2]
    out = dit_apply(params, cfg, torch.cat([half, half]), t, y)
    eps, rest = out[..., :3], out[..., 3:]
    cond_eps, uncond_eps = torch.chunk(eps, 2, dim=0)
    half_eps = uncond_eps + cfg_scale * (cond_eps - uncond_eps)
    return torch.cat([torch.cat([half_eps, half_eps]), rest], dim=-1)


# ---------------------------------------------------------------------------
# the block variants (no reference config builds either)
# ---------------------------------------------------------------------------

class DiTCrossAttnBlock(nn.Module):
    """The adaLN-Zero block with a cross-attention stage between the
    self-attention and the MLP; ``cross_modulate`` gives that stage its own
    (gate, shift, scale) modulation."""

    def __init__(self, hidden, encoder_hidden, num_heads, mlp_ratio=4.0, cross_modulate=True):
        super().__init__()
        self.num_heads = num_heads
        self.attn = ViTAttention(hidden)
        self.cross_attn = CrossAttention(hidden, encoder_hidden)
        self.mlp = Mlp(hidden, int(hidden * mlp_ratio))
        self.adaLN_modulation = nn.Sequential(nn.SiLU(), nn.Linear(hidden, 6 * hidden))
        if cross_modulate:
            self.cross_modulation = nn.Sequential(nn.SiLU(), nn.Linear(hidden, 3 * hidden))


def dit_cross_attn_block_apply(p: DiTCrossAttnBlock, num_heads, x, c, encoder_hidden_states,
                               mask=None):
    """Without ``cross_modulation`` the cross stage is neither modulated nor
    masked (the reference drops ``mask`` there)."""
    shift_msa, scale_msa, gate_msa, shift_mlp, scale_mlp, gate_mlp = \
        torch.chunk(_adaln(p.adaLN_modulation, c), 6, dim=-1)
    x = x + gate_msa[:, None] * vit_attention_apply(
        p.attn, num_heads, modulate(layer_norm(x), shift_msa, scale_msa))
    if hasattr(p, "cross_modulation"):
        gate_mca, shift_mca, scale_mca = torch.chunk(_adaln(p.cross_modulation, c), 3, dim=-1)
        x = x + gate_mca[:, None] * cross_attention_apply(
            p.cross_attn, num_heads, modulate(layer_norm(x), shift_mca, scale_mca),
            encoder_hidden_states, mask)
    else:
        x = x + cross_attention_apply(p.cross_attn, num_heads, layer_norm(x),
                                      encoder_hidden_states)
    return x + gate_mlp[:, None] * mlp_apply(p.mlp, modulate(layer_norm(x), shift_mlp, scale_mlp))


@dataclasses.dataclass
class DiTDualConfig:
    """The DiT dual block's geometry. Its DualAttention's image stream is
    the q tokens (width q_dim, ``num_heads`` heads) and its query stream
    the DiT latent tokens (width hidden_size, ``query_heads`` heads)."""
    hidden_size: int
    q_dim: int
    num_heads: int
    query_heads: int
    mlp_ratio: float = 4.0
    dit_attention: str = "bi"           # 'bi' | 'uni' | 'uni-0'
    qk_norm: bool = False

    @property
    def bidirectional(self):
        return self.dit_attention == "bi"

    @property
    def zero_init(self):
        return self.dit_attention == "uni-0"

    def attention_config(self) -> EncoderConfig:
        return EncoderConfig(K=1, hidden_size=self.q_dim, query_dim=self.hidden_size,
                             num_heads=self.num_heads, query_heads=self.query_heads,
                             bidirectional=self.bidirectional, zero_init=self.zero_init,
                             qk_norm=self.qk_norm)


class DiTDualBlock(nn.Module):
    def __init__(self, cfg: DiTDualConfig):
        super().__init__()
        D, Dq = cfg.hidden_size, cfg.q_dim
        self.attn = DualAttention(cfg.attention_config())
        self.mlp = Mlp(D, int(D * cfg.mlp_ratio))
        self.q_mlp = Mlp(Dq, int(Dq * cfg.mlp_ratio))
        self.adaLN_modulation = nn.Sequential(nn.SiLU(), nn.Linear(D, 6 * D))
        self.adaLN_modulation_q = nn.Sequential(nn.SiLU(), nn.Linear(Dq, 6 * Dq))


def dit_dual_block_apply(p: DiTDualBlock, cfg: DiTDualConfig, x, t_emb, t_emb_q, q, mask=None):
    """The SD3-style two-stream adaLN block. x: [B,N,hidden] latent tokens;
    q: [B,K,q_dim] query tokens; mask: [B,K] keep-mask over q. In 'bi'
    mode the q stream's modulations come from t_emb, as in the reference.
    The reference's MLP residual quirk is kept: the MLP reads the
    post-attention activations and adds onto the pre-attention x / q."""
    B, N, _ = x.shape
    shift_x, scale_x, gate_x, shift_mx, scale_mx, gate_mx = \
        torch.chunk(_adaln(p.adaLN_modulation, t_emb), 6, dim=-1)
    t_for_q = t_emb if cfg.bidirectional else t_emb_q
    shift_q, scale_q, gate_q, shift_mq, scale_mq, gate_mq = \
        torch.chunk(_adaln(p.adaLN_modulation_q, t_for_q), 6, dim=-1)
    joint_mask = x_mask = None
    if mask is not None:
        ones_x = torch.ones((B, N), dtype=torch.bool, device=x.device)
        # the keys are [q tokens || x tokens]
        joint_mask = torch.cat([mask.bool(), ones_x], dim=1)[:, None, None, :]
        if not cfg.bidirectional:
            x_mask = mask.bool()[:, None, None, :]
    q_attn, x_attn = dual_attention_apply(
        p.attn, cfg.attention_config(), modulate(layer_norm(q), shift_q, scale_q),
        modulate(layer_norm(x), shift_x, scale_x), mask=joint_mask, x_mask=x_mask)
    x_res = x + gate_x[:, None] * x_attn
    q_res = q + gate_q[:, None] * q_attn
    x = x + gate_mx[:, None] * mlp_apply(p.mlp, modulate(layer_norm(x_res), shift_mx, scale_mx))
    q = q + gate_mq[:, None] * mlp_apply(p.q_mlp, modulate(layer_norm(q_res), shift_mq, scale_mq))
    return x, q
