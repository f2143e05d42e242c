"""The Selftok encoder in its unidirectional dual form (two streams a block:
the image tokens self-attend; the K query tokens attend over the image
tokens' keys and their own), the cosine VQ and the codebook context that
the decoder reads, plain fp32, over the tokenizer state dict's
``encoder.*`` names.

``cfg`` is the ``encoder`` group of the benchmark's configuration file.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from benchmark.reference.nn import (
    attention, center_crop, gelu_tanh, heads, layer_norm, linear, merge, modulate,
    patchify, timestep_mlp)

P = "encoder."


def _mlp(sd, name, x):
    return linear(gelu_tanh(linear(x, sd, name + ".fc1")), sd, name + ".fc2")


def _block(sd, cfg, i, x, q, positions):
    b = f"{P}blocks.{i}"
    mods = linear(F.silu(timestep_mlp(sd, b + ".t_embedder", positions)),
                  sd, b + ".adaLN_modulation.1")
    shift_msa, scale_msa, gate_msa, shift_mlp, scale_mlp, gate_mlp = mods.chunk(6, dim=-1)
    H, QH = cfg["num_heads"], cfg["query_heads"]

    xn = layer_norm(x)
    qn = modulate(layer_norm(q), shift_msa, scale_msa)
    xq, xk, xv = (heads(t, H) for t in linear(xn, sd, b + ".attn.qkv").chunk(3, dim=-1))
    qq, qk, qv = (heads(t, QH) for t in linear(qn, sd, b + ".attn.query_linear").chunk(3, dim=-1))
    ik, iv = (heads(t, QH) for t in linear(xn, sd, b + ".attn.to_query_kv").chunk(2, dim=-1))
    x_attn = linear(merge(attention(xq, xk, xv)), sd, b + ".attn.proj")
    q_attn = attention(qq, torch.cat([ik, qk], dim=2), torch.cat([iv, qv], dim=2))
    q_attn = linear(merge(q_attn), sd, b + ".attn.query_proj")

    x = x + x_attn
    x = x + _mlp(sd, b + ".mlp", layer_norm(x))
    q = q + gate_msa * q_attn
    q = q + gate_mlp * _mlp(sd, b + ".q_mlp", modulate(layer_norm(q), shift_mlp, scale_mlp))
    return x, q


def pre_vq(sd, cfg, latents):
    """Latents NHWC [B, h, w, C] -> the quantizer's input [B, K, query_dim]."""
    p = cfg["patch_size"]
    gh, gw = latents.shape[1] // p, latents.shape[2] // p
    x = patchify(latents, sd, P + "x_embedder.proj", p)
    x = x + center_crop(sd[P + "pos_embed"], cfg["pos_embed_max_size"], gh, gw)
    K = cfg["K"]
    q = sd[P + "query_tokens"].expand(latents.shape[0], K, cfg["query_dim"])
    positions = 1000.0 + 8.0 * torch.arange(K, dtype=torch.float32, device=latents.device)
    for i in range(cfg["depth"]):
        x, q = _block(sd, cfg, i, x, q, positions)
    return q


def vq_scores(sd, outs):
    """Cosine scores [B, K, C] of the l2-normalised projected features
    against the codebook."""
    z = linear(outs, sd, P + "quantizer.project_in")
    z = z / torch.clamp(torch.linalg.vector_norm(z, dim=-1, keepdim=True), min=1e-12)
    return torch.matmul(z, sd[P + "quantizer._codebook.embed"][0].t())


def encode(sd, cfg, latents):
    """(ids [B, K] int64, the first code of the highest score; top-2 score
    margins [B, K])."""
    scores = vq_scores(sd, pre_vq(sd, cfg, latents))
    top2 = torch.topk(scores, 2, dim=-1).values
    return torch.argmax(scores, dim=-1), top2[..., 0] - top2[..., 1]


def context(sd, ids):
    """ids [B, K] -> the decoder's context [B, K, encoder_hidden_size]: the
    codes, then the encoder's last LayerNorm (post_norm)."""
    codes = sd[P + "quantizer._codebook.embed"][0][ids.long()]
    if P + "quantizer.project_out.weight" in sd:
        codes = linear(codes, sd, P + "quantizer.project_out")
    return layer_norm(codes, sd[P + "final_layer_norm3.weight"], sd[P + "final_layer_norm3.bias"])
