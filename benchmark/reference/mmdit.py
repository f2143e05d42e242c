"""The MMDiT decoder (SD3-style joint attention; the context stream's adaLN
from a per-position table, the x stream's from the timestep), its one-step
mask-token renderer, and the 50-step Euler sampler with its per-step token
counts, over the tokenizer state dict's ``model.*`` names.

The decoder computes in ``dt``, the type the cell states for it: fp32, or
bf16 activations with the timestep embedding and the context table in fp32
before their cast, norm statistics and softmax in fp32, products
accumulated in fp32, the bf16 attention in the online form
(``nn.attention_online``). The sampler's state and its steps stay fp32.

``cfg`` is the ``decoder`` group of the benchmark's configuration file;
the sampler also reads its ``diti`` group and ``K``.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from benchmark.reference.nn import (
    attention, attention_online, center_crop, gelu_tanh, heads, layer_norm, linear, merge, modulate,
    patchify, timestep_mlp)

P = "model."


def _mlp(sd, name, x):
    return linear(gelu_tanh(linear(x, sd, name + ".fc1")), sd, name + ".fc2")


def context_mods(sd, cfg, length):
    """Each context block's adaLN modulations over the positions
    1000 + 8k, k < length, in fp32: a list of depth - 1 tensors
    [length, 6 * hidden]."""
    pos = 1000.0 + 8.0 * torch.arange(length, dtype=torch.float32,
                                      device=sd[P + "context_pos_embed"].device)
    out = []
    for i in range(cfg["depth"] - 1):
        b = f"{P}joint_blocks.{i}.context_block"
        out.append(linear(F.silu(timestep_mlp(sd, b + ".t_embedder", pos)),
                          sd, b + ".adaLN_modulation.1"))
    return out


def _qkv(sd, name, x, n_heads):
    return [heads(t, n_heads) for t in linear(x, sd, name + ".attn.qkv").chunk(3, dim=-1)]


def _post(sd, name, x, attn, gate_msa, shift_mlp, scale_mlp, gate_mlp):
    x = x + gate_msa * linear(attn, sd, name + ".attn.proj")
    return x + gate_mlp * _mlp(sd, name + ".mlp", modulate(layer_norm(x), shift_mlp, scale_mlp))


def trunk(sd, cfg, ctx, x, c, mods, key_mask=None, ctx_sees_x=True):
    """The joint blocks and the final layer, in the type of x. ctx [B, Lc, D];
    x [B, N, D]; c [B, D]; mods: ``context_mods`` cut to Lc, in x's type;
    key_mask [B, Lc + N] for every row. ctx_sees_x False: the context rows
    attend over the context keys alone (the renderer). Returns the final
    layer's [B, N, p*p*C]."""
    H = cfg["num_heads"]
    depth = cfg["depth"]
    Lc = ctx.shape[1]
    cs = F.silu(c)

    def attn(q, k, v, mask):
        if q.dtype == torch.float32:
            return attention(q, k, v, mask, fp32_scores=True)
        return attention_online(q, k, v, mask)

    for i in range(depth):
        b = f"{P}joint_blocks.{i}"
        last = i == depth - 1
        if last:
            shift, scale = linear(cs, sd, b + ".context_block.adaLN_modulation.1")[:, None].chunk(2, -1)
            cq, ck, cv = _qkv(sd, b + ".context_block", modulate(layer_norm(ctx), shift, scale), H)
        else:
            cm = mods[i].chunk(6, dim=-1)
            cq, ck, cv = _qkv(sd, b + ".context_block", modulate(layer_norm(ctx), cm[0], cm[1]), H)
        xm = linear(cs, sd, b + ".x_block.adaLN_modulation.1")[:, None].chunk(6, dim=-1)
        xq, xk, xv = _qkv(sd, b + ".x_block", modulate(layer_norm(x), xm[0], xm[1]), H)
        k, v = torch.cat([ck, xk], dim=2), torch.cat([cv, xv], dim=2)
        if ctx_sees_x:
            out = merge(attn(torch.cat([cq, xq], dim=2), k, v, key_mask))
            c_attn, x_attn = out[:, :Lc], out[:, Lc:]
        else:
            c_attn = merge(attn(cq, ck, cv, None if key_mask is None else key_mask[:, :Lc]))
            x_attn = merge(attn(xq, k, v, key_mask))
        if not last:
            ctx = _post(sd, b + ".context_block", ctx, c_attn, cm[2], cm[3], cm[4], cm[5])
        x = _post(sd, b + ".x_block", x, x_attn, xm[2], xm[3], xm[4], xm[5])
    shift, scale = linear(cs, sd, P + "final_layer.adaLN_modulation.1")[:, None].chunk(2, -1)
    return linear(modulate(layer_norm(x), shift, scale), sd, P + "final_layer.linear")


def unpatchify(out, patch, channels, gh, gw):
    b = out.shape[0]
    out = out.reshape(b, gh, gw, patch, patch, channels).permute(0, 1, 3, 2, 4, 5)
    return out.reshape(b, gh * patch, gw * patch, channels)


def velocity(sd, cfg, x, t, ehs, mask, mods, dt=torch.float32):
    """One decoder call in ``dt``: x NHWC [B, h, w, C] noised latents, t [B]
    in [0, 1], ehs [B, Lc, 16] the context, mask [B, Lc] its active tokens,
    mods ``context_mods``. Returns the fp32 velocity."""
    p = cfg["patch_size"]
    gh, gw = x.shape[1] // p, x.shape[2] // p
    xt = patchify(x.to(dt), sd, P + "x_embedder.proj", p)
    xt = xt + center_crop(sd[P + "pos_embed"], cfg["pos_embed_max_size"], gh, gw).to(dt)
    c = timestep_mlp(sd, P + "t_embedder", t * 1000.0).to(dt)
    Lc = ehs.shape[1]
    ctx = linear(ehs.to(dt), sd, P + "context_embedder") + sd[P + "context_pos_embed"][:, :Lc].to(dt)
    key_mask = torch.cat([mask, torch.ones(mask.shape[0], xt.shape[1], dtype=torch.bool,
                                           device=mask.device)], dim=1)
    out = trunk(sd, cfg, ctx, xt, c, [m.to(dt)[:Lc] for m in mods], key_mask)
    return unpatchify(out, p, x.shape[-1], gh, gw).float()


def render(sd, cfg, ehs, dt=torch.float32):
    """The one-step renderer in ``dt``: the mask token over the latent grid
    at t = 1000, the context rows over the context keys alone; the context
    embedded in fp32 and then cast. ehs [B, K, 16] fp32 -> latents NHWC
    [B, grid * 2, grid * 2, C] in ``dt``."""
    B, K = ehs.shape[:2]
    grid = cfg["input_size"] // cfg["patch_size"]
    D = cfg["hidden_size"]
    x = sd[P + "mask_token"].to(dt).expand(B, grid * grid, D) + sd[P + "positional_embedding"].to(dt)
    c = timestep_mlp(sd, P + "t_embedder", torch.full((B,), 1000.0, device=ehs.device)).to(dt)
    ctx = (linear(ehs.float(), sd, P + "context_embedder")
           + sd[P + "context_pos_embed"].float()).to(dt)
    mods = [m.to(dt) for m in context_mods(sd, cfg, K)]
    out = trunk(sd, cfg, ctx, x, c, mods, ctx_sees_x=False)
    return unpatchify(out, cfg["patch_size"], cfg["in_channels"], grid, grid)


# ---------------------------------------------------------------- sampler

def schedule(steps):
    """(t, t_prev, timestep_map) of the uniform schedule from 1 to 0, fp32."""
    base = np.linspace(1.0, 0.0, steps + 1, dtype=np.float32)
    return base[:-1], base[1:], (base[:-1] * 1000.0).astype(np.float32)


def diti_indices(diti, K, t):
    """The last active token at timesteps t (fp32, in [0, 1000]): the
    continuous piecewise-linear map of the DiTi stages, in fp32 as the
    tokenizer computes it."""
    ind = torch.zeros_like(t)
    lo, acc = 0, 0
    for hi, k in zip(diti["stages"], diti["k_per_stage"]):
        ind = torch.where(t - float(lo) >= 0, float(k) / (hi - lo) * (t - float(lo)) + float(acc),
                          ind)
        lo, acc = hi, acc + k
    return torch.clamp(ind.to(torch.int32), 0, K - 1)


def step_tokens(diti, K, timestep_map):
    """The last active token of each sampler step: the map at the truncated
    timestep."""
    return diti_indices(diti, K, torch.from_numpy(np.trunc(timestep_map).astype(np.float32))).numpy()


def buckets(step_k, K):
    """Steps grouped by the 128-multiple context length that covers their
    active tokens: [(first step, end step, context length)]. Masked tokens
    get weight 0, so cutting the context to the bucket changes nothing."""
    if K % 128:
        return [(0, len(step_k), K)]
    b = np.minimum(((np.asarray(step_k) + 1 + 127) // 128) * 128, K)
    out, s = [], 0
    for i in range(1, len(b) + 1):
        if i == len(b) or b[i] != b[s]:
            out.append((s, i, int(b[s])))
            s = i
    return out


def sample(sd, cfg, diti, K, steps, ehs, noise, dt=torch.float32):
    """The Euler sampler from noise (NHWC fp32) to the final fp32 latents,
    the decoder in ``dt``."""
    t_now, t_prev, tm = schedule(steps)
    step_k = step_tokens(diti, K, tm)
    mods = context_mods(sd, cfg, K)
    B = noise.shape[0]
    dev = noise.device
    x = noise
    for s, e, Lc in buckets(step_k, K):
        for i in range(s, e):
            t = torch.full((B,), float(t_now[i]), device=dev)
            mask = (torch.arange(Lc, device=dev) <= int(step_k[i]))[None].expand(B, Lc)
            v = velocity(sd, cfg, x, t, ehs[:, :Lc], mask, mods, dt)
            x = x - (torch.tensor(t_now[i], device=dev) - torch.tensor(t_prev[i], device=dev)) * v
    return x
