"""Weights carried across from the JAX package's parameter trees.

``tokenizer_from_jax_tree`` and ``vae_from_jax_tree`` take the nested dicts
that the reference package's ``tokenizer_init`` / ``vae_init`` return, with
every leaf already a numpy array (the caller converts with ``np.asarray``),
and load them into the port's modules. The layout differences are undone
here: ``[in, out]`` matmul weights -> ``[out, in]``, HWIO conv kernels ->
OIHW, flattened ``[p*p*C, D]`` patch-embed weights -> conv ``[D, C, p, p]``,
depth-stacked block leaves -> per-block entries, the separate ``last_block``
-> ``joint_blocks[depth-1]``. The resulting names are those of a reference
checkpoint, so loading is ``load_state_dict(strict=True)``. Nothing here
imports JAX.
"""

from __future__ import annotations

import numpy as np
import torch

from selftoktokenizer_tpu_torch.models.tokenizer import ImageTokenizer, TokenizerConfig
from selftoktokenizer_tpu_torch.models.vae import SDVAE, VAEConfig


def _t(a):
    return torch.from_numpy(np.array(a, dtype=np.float32, order="C"))   # a copy


def _linear(out, prefix, p):
    out[prefix + ".weight"] = _t(np.asarray(p["w"]).T)
    if "b" in p:
        out[prefix + ".bias"] = _t(p["b"])


def _layernorm(out, prefix, p):
    out[prefix + ".weight"] = _t(p["scale"])
    out[prefix + ".bias"] = _t(p["bias"])


def _conv2d(out, prefix, p):
    out[prefix + ".weight"] = _t(np.asarray(p["w"]).transpose(3, 2, 0, 1))  # HWIO -> OIHW
    if "b" in p:
        out[prefix + ".bias"] = _t(p["b"])


def _patch_embed(out, prefix, p, patch, c_in):
    w = np.asarray(p["w"])                       # [p*p*C, D], (p, p, C) order
    w = w.reshape(patch, patch, c_in, w.shape[1])
    out[prefix + ".proj.weight"] = _t(w.transpose(3, 2, 0, 1))   # [D, C, p, p]
    out[prefix + ".proj.bias"] = _t(p["b"])


def _mlp(out, prefix, p):
    _linear(out, prefix + ".fc1", p["fc1"])
    _linear(out, prefix + ".fc2", p["fc2"])


def _timestep_embedder(out, prefix, p):
    _linear(out, prefix + ".mlp.0", p["mlp0"])
    _linear(out, prefix + ".mlp.2", p["mlp2"])


def _unstack(stacked, i):
    """Entry i of a depth-stacked tree."""
    if isinstance(stacked, dict):
        return {k: _unstack(v, i) for k, v in stacked.items()}
    return np.asarray(stacked)[i]


def _rmsnorm(out, prefix, p):
    out[prefix + ".weight"] = _t(p["weight"])


def encoder_state_dict(p, cfg):
    """JAX encoder tree (mode 'dual') -> reference-named state dict."""
    out = {}
    _patch_embed(out, "x_embedder", p["x_embedder"], cfg.patch_size, cfg.in_channels)
    out["pos_embed"] = _t(p["pos_embed"])
    for n in ("final_layer_norm", "final_layer_norm2", "final_layer_norm3"):
        _layernorm(out, n, p[n])
    q = p["quantizer"]
    if "project_in" in q:
        _linear(out, "quantizer.project_in", q["project_in"])
    if "project_out" in q:
        _linear(out, "quantizer.project_out", q["project_out"])
    out["quantizer._codebook.embed"] = _t(np.asarray(q["embed"])[None])
    out["query_tokens"] = _t(p["query_tokens"])
    for i in range(cfg.depth):
        b = _unstack(p["blocks"], i)
        pre = f"blocks.{i}."
        for n in ("qkv", "query_linear", "proj", "query_proj", "to_query_kv"):
            _linear(out, pre + "attn." + n, b[n])
        _mlp(out, pre + "mlp", b["mlp"])
        _mlp(out, pre + "q_mlp", b["q_mlp"])
        if cfg.qk_norm:
            for n in ("q_norm", "k_norm", "query_qnorm", "query_knorm"):
                _rmsnorm(out, pre + "attn." + n, b[n])
        if cfg.time_adaln:
            _linear(out, pre + "adaLN_modulation.1", b["adaLN"])
            _timestep_embedder(out, pre + "t_embedder", b["t_embedder"])
    return out


def _dismantled(out, pre, b, cfg, pre_only=False):
    _linear(out, pre + "attn.qkv", b["qkv"])
    _linear(out, pre + "adaLN_modulation.1", b["adaLN"])
    if cfg.qk_norm == "rms":
        _rmsnorm(out, pre + "attn.ln_q", b["ln_q"])
        _rmsnorm(out, pre + "attn.ln_k", b["ln_k"])
    if not pre_only:
        _linear(out, pre + "attn.proj", b["proj"])
        _mlp(out, pre + "mlp", b["mlp"])
    if "t_embedder" in b:
        _timestep_embedder(out, pre + "t_embedder", b["t_embedder"])


def mmdit_state_dict(p, cfg):
    """JAX MMDiT tree -> reference-named state dict."""
    out = {}
    _timestep_embedder(out, "t_embedder", p["t_embedder"])
    out["context_pos_embed"] = _t(p["context_pos_embed"])
    _linear(out, "final_layer.linear", p["final_layer"]["linear"])
    _linear(out, "final_layer.adaLN_modulation.1", p["final_layer"]["adaLN"])
    _patch_embed(out, "x_embedder", p["x_embedder"], cfg.patch_size, cfg.in_channels)
    out["pos_embed"] = _t(p["pos_embed"])
    _linear(out, "context_embedder", p["context_embedder"])
    if "y_embedder" in p:
        _timestep_embedder(out, "y_embedder", p["y_embedder"])
    if "register" in p:
        out["register"] = _t(p["register"])
    for i in range(cfg.depth - 1):
        b = _unstack(p["joint_blocks"], i)
        pre = f"joint_blocks.{i}."
        _dismantled(out, pre + "context_block.", b["context_block"], cfg)
        _dismantled(out, pre + "x_block.", b["x_block"], cfg)
    pre = f"joint_blocks.{cfg.depth - 1}."
    lb = p["last_block"]
    _dismantled(out, pre + "context_block.", lb["context_block"], cfg, pre_only=True)
    _dismantled(out, pre + "x_block.", lb["x_block"], cfg)
    return out


def tokenizer_from_jax_tree(tree, tcfg: TokenizerConfig) -> ImageTokenizer:
    """{'encoder': ..., ['model': ...]} of numpy leaves -> ImageTokenizer
    (on the CPU, fp32; encode-only when the tree has no 'model')."""
    encode_only = "model" not in tree
    tok = ImageTokenizer(tcfg, encode_only=encode_only)
    sd = {"encoder." + k: v
          for k, v in encoder_state_dict(tree["encoder"], tcfg.encoder).items()}
    if not encode_only:
        sd.update({"model." + k: v
                   for k, v in mmdit_state_dict(tree["model"], tcfg.decoder).items()})
    tok.load_state_dict(sd, strict=True)
    return tok


def _resnet(out, pre, p):
    _layernorm(out, pre + "norm1", p["norm1"])
    _conv2d(out, pre + "conv1", p["conv1"])
    _layernorm(out, pre + "norm2", p["norm2"])
    _conv2d(out, pre + "conv2", p["conv2"])
    if "nin_shortcut" in p:
        _conv2d(out, pre + "nin_shortcut", p["nin_shortcut"])


def _mid(out, pre, p):
    _resnet(out, pre + "block_1.", p["block_1"])
    _layernorm(out, pre + "attn_1.norm", p["attn_1"]["norm"])
    for n in ("q", "k", "v", "proj_out"):
        _conv2d(out, pre + "attn_1." + n, p["attn_1"][n])
    _resnet(out, pre + "block_2.", p["block_2"])


def vae_state_dict(tree):
    out = {}
    for side, levels, resample in (("encoder", "down", "downsample"),
                                   ("decoder", "up", "upsample")):
        p = tree[side]
        pre = side + "."
        _conv2d(out, pre + "conv_in", p["conv_in"])
        _conv2d(out, pre + "conv_out", p["conv_out"])
        _layernorm(out, pre + "norm_out", p["norm_out"])
        _mid(out, pre + "mid.", p["mid"])
        for i, lvl in enumerate(p[levels]):
            for j, blk in enumerate(lvl["block"]):
                _resnet(out, f"{pre}{levels}.{i}.block.{j}.", blk)
            if resample in lvl:
                _conv2d(out, f"{pre}{levels}.{i}.{resample}.conv", lvl[resample]["conv"])
    return out


def vae_from_jax_tree(tree, vae_cfg: VAEConfig = None) -> SDVAE:
    """{'encoder': ..., 'decoder': ...} of numpy leaves -> SDVAE (CPU, fp32)."""
    vae = SDVAE(vae_cfg)
    vae.load_state_dict(vae_state_dict(tree), strict=True)
    return vae
