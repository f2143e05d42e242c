"""Weights carried across from the JAX package's parameter trees.

``tokenizer_from_jax_tree`` and ``vae_from_jax_tree`` (and the
``*_from_jax_tree`` of every other model: the multi-resolution encoder and
MMDiT, the multi-resolution tokenizer, DiT and its two block variants,
CLIP, T5, the Inception-V3 and LPIPS-VGG16 evaluation nets) take the nested
dicts that the reference package's ``*_init`` functions return, with
every leaf already a numpy array (the caller converts with ``np.asarray``),
and load them into the port's modules. The layout differences are undone
here: ``[in, out]`` matmul weights -> ``[out, in]``, HWIO conv kernels ->
OIHW, flattened ``[p*p*C, D]`` patch-embed weights -> conv ``[D, C, p, p]``,
depth-stacked block leaves -> per-block entries, the separate ``last_block``
-> ``joint_blocks[depth-1]``. The resulting names are those of a reference
checkpoint, so loading is ``load_state_dict(strict=True)``. The maps are
linear in each leaf, so ``tokenizer_state_dict`` also carries a gradient
tree or an optimizer's parameters across by the same names. Nothing here
imports JAX.
"""

from __future__ import annotations

import numpy as np
import torch

from selftoktokenizer_tpu_torch.eval import inception as inception_mod
from selftoktokenizer_tpu_torch.eval import lpips as lpips_mod
from selftoktokenizer_tpu_torch.models import dit as dit_mod
from selftoktokenizer_tpu_torch.models import text_encoders as te
from selftoktokenizer_tpu_torch.models.encoder import QformerEncoderMultiRes
from selftoktokenizer_tpu_torch.models.mmdit import MMDiT
from selftoktokenizer_tpu_torch.models.tokenizer import (
    ImageTokenizer, MultiImageTokenizer, MultiTokenizerConfig, TokenizerConfig)
from selftoktokenizer_tpu_torch.models.vq import VQState
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


def _quantizer(out, q):
    if "project_in" in q:
        _linear(out, "quantizer.project_in", q["project_in"])
    if "project_out" in q:
        _linear(out, "quantizer.project_out", q["project_out"])
    out["quantizer._codebook.embed"] = _t(np.asarray(q["embed"])[None])


def encoder_state_dict(p, cfg):
    """JAX encoder tree (any mode) -> reference-named state dict."""
    out = {}
    _patch_embed(out, "x_embedder", p["x_embedder"], cfg.patch_size, cfg.in_channels)
    out["pos_embed"] = _t(p["pos_embed"])
    for n in ("final_layer_norm", "final_layer_norm2", "final_layer_norm3"):
        _layernorm(out, n, p[n])
    _quantizer(out, p["quantizer"])
    mode = cfg.qformer_mode
    if mode != "vit":
        out["query_tokens"] = _t(p["query_tokens"])
    if mode == "qformer":
        qf = p["qformer"]
        for i in range(cfg.depth):
            b = _unstack(qf["blocks"], i)
            for n in ("to_q", "kv", "proj"):
                _linear(out, f"qformer.qformer_blocks.{i}.{n}", b[n])
        _mlp(out, "qformer.vision_proj", qf["vision_proj"])
        return out
    for i in range(cfg.depth):
        b = _unstack(p["blocks"], i)
        pre = f"blocks.{i}."
        if mode == "dual":
            for n in ("qkv", "query_linear", "proj", "query_proj", "to_query_kv"):
                if n in b:
                    _linear(out, pre + "attn." + n, b[n])
            if "gate" in b:
                out[pre + "attn.gate"] = _t(b["gate"])
            _mlp(out, pre + "q_mlp", b["q_mlp"])
            if cfg.qk_norm:
                for n in ("q_norm", "k_norm", "query_qnorm", "query_knorm"):
                    _rmsnorm(out, pre + "attn." + n, b[n])
        else:   # vit and concat: one fused-attention block layout
            _linear(out, pre + "attn.qkv", b["attn"]["qkv"])
            _linear(out, pre + "attn.proj", b["attn"]["proj"])
        _mlp(out, pre + "mlp", b["mlp"])
        if cfg.time_adaln and mode != "vit":
            _linear(out, pre + "adaLN_modulation.1", b["adaLN"])
            _timestep_embedder(out, pre + "t_embedder", b["t_embedder"])
    return out


def _dismantled(out, pre, b, cfg, pre_only=False):
    _linear(out, pre + "attn.qkv", b["qkv"])
    _linear(out, pre + "adaLN_modulation.1", b["adaLN"])
    if cfg.qk_norm == "rms":
        _rmsnorm(out, pre + "attn.ln_q", b["ln_q"])
        _rmsnorm(out, pre + "attn.ln_k", b["ln_k"])
    elif cfg.qk_norm == "ln":
        _layernorm(out, pre + "attn.ln_q", b["ln_q"])
        _layernorm(out, pre + "attn.ln_k", b["ln_k"])
    if not pre_only:
        _linear(out, pre + "attn.proj", b["proj"])
        _mlp(out, pre + "mlp", b["mlp"])
    if "t_embedder" in b:
        _timestep_embedder(out, pre + "t_embedder", b["t_embedder"])


def _multires(p):
    return "x_embedder_clean" in p


def mmdit_state_dict(p, cfg):
    """JAX MMDiT tree (a decoder, a renderer or the multi-resolution MMDiT)
    -> reference-named state dict."""
    out = {}
    _timestep_embedder(out, "t_embedder", p["t_embedder"])
    out["context_pos_embed"] = _t(p["context_pos_embed"])
    _linear(out, "final_layer.linear", p["final_layer"]["linear"])
    _linear(out, "final_layer.adaLN_modulation.1", p["final_layer"]["adaLN"])
    if cfg.renderer:
        out["positional_embedding"] = _t(p["positional_embedding"])
        out["mask_token"] = _t(p["mask_token"])
    else:
        _patch_embed(out, "x_embedder", p["x_embedder"], cfg.patch_size, cfg.in_channels)
        out["pos_embed"] = _t(p["pos_embed"])
    _linear(out, "context_embedder", p["context_embedder"])
    if "y_embedder" in p:
        _timestep_embedder(out, "y_embedder", p["y_embedder"])
    if "register" in p:
        out["register"] = _t(p["register"])
    if _multires(p):
        _patch_embed(out, "x_embedder_clean", p["x_embedder_clean"], cfg.patch_size,
                     cfg.in_channels)
        _linear(out, "context_embedder_low_res", p["context_embedder_low_res"])
    for i in range(cfg.depth - 1):
        b = _unstack(p["joint_blocks"], i)
        pre = f"joint_blocks.{i}."
        for n in ("context_block", "x_block", "context_block_low_res", "rec_block"):
            if n in b:
                _dismantled(out, pre + n + ".", b[n], cfg)
    pre = f"joint_blocks.{cfg.depth - 1}."
    lb = p["last_block"]
    for n in ("context_block", "x_block", "context_block_low_res", "rec_block"):
        if n in lb:
            _dismantled(out, pre + n + ".", lb[n], cfg,
                        pre_only=n in ("context_block", "context_block_low_res"))
    return out


def mmdit_from_jax_tree(tree, cfg) -> MMDiT:
    """A JAX MMDiT tree (with the multi-resolution leaves or without) ->
    MMDiT (CPU, fp32)."""
    m = MMDiT(cfg, multires=_multires(tree))
    m.load_state_dict(mmdit_state_dict(tree, cfg), strict=True)
    return m


def multires_encoder_state_dict(p, cfg):
    """JAX multi-resolution encoder tree -> reference-named state dict."""
    out = {}
    _patch_embed(out, "x_embedder", p["x_embedder"], cfg.patch_size, cfg.in_channels)
    for n in ("pos_embed", "query_tokens", "low_res_hidden_pos_embed"):
        out[n] = _t(p[n])
    for n in ("final_layer_norm", "final_layer_norm2", "final_layer_norm3"):
        _layernorm(out, n, p[n])
    _quantizer(out, p["quantizer"])
    if "token_embedder" in p:
        _linear(out, "token_embedder", p["token_embedder"])
    for i in range(cfg.depth):
        b = _unstack(p["blocks"], i)
        pre = f"blocks.{i}."
        for n in ("qkv", "query_linear", "low_res_linear", "x_to_query_kv",
                  "low_res_to_query_kv", "proj", "query_proj", "low_res_proj"):
            _linear(out, pre + "attn." + n, b[n])
        for n in ("mlp", "q_mlp", "low_res_mlp"):
            _mlp(out, pre + n, b[n])
        if cfg.time_adaln:
            _linear(out, pre + "adaLN_modulation.1", b["adaLN"])
            _timestep_embedder(out, pre + "t_embedder", b["t_embedder"])
            _linear(out, pre + "adaLN_modulation_low_res.1", b["adaLN_low_res"])
            _timestep_embedder(out, pre + "t_embedder_low_res", b["t_embedder_low_res"])
    return out


def multires_encoder_from_jax_tree(tree, cfg) -> QformerEncoderMultiRes:
    enc = QformerEncoderMultiRes(cfg)
    enc.load_state_dict(multires_encoder_state_dict(tree, cfg), strict=True)
    return enc


def multi_tokenizer_state_dict(tree, cfg: MultiTokenizerConfig):
    """{'encoder': {resolution: ...}, 'model': ...} -> the state dict of a
    MultiImageTokenizer (``encoder.<resolution>.*``, ``model.*``)."""
    sd = {"model." + k: v for k, v in mmdit_state_dict(tree["model"], cfg.decoder).items()}
    for res, ec in cfg.encoders.items():
        sd.update({f"encoder.{res}.{k}": v
                   for k, v in encoder_state_dict(tree["encoder"][res], ec).items()})
    return sd


def multi_tokenizer_from_jax_tree(tree, cfg: MultiTokenizerConfig) -> MultiImageTokenizer:
    tok = MultiImageTokenizer(cfg)
    tok.load_state_dict(multi_tokenizer_state_dict(tree, cfg), strict=True)
    return tok


def _dit_block(out, pre, b):
    _linear(out, pre + "attn.qkv", b["attn"]["qkv"])
    _linear(out, pre + "attn.proj", b["attn"]["proj"])
    _mlp(out, pre + "mlp", b["mlp"])
    _linear(out, pre + "adaLN_modulation.1", b["adaLN"])


def dit_state_dict(p, cfg):
    """JAX DiT tree -> reference-named state dict."""
    out = {}
    _patch_embed(out, "x_embedder", p["x_embedder"], cfg.patch_size, cfg.in_channels)
    out["pos_embed"] = _t(p["pos_embed"])
    _timestep_embedder(out, "t_embedder", p["t_embedder"])
    out["y_embedder.embedding_table.weight"] = _t(p["y_embedder"]["table"])
    for i in range(cfg.depth):
        _dit_block(out, f"blocks.{i}.", _unstack(p["blocks"], i))
    _linear(out, "final_layer.linear", p["final_layer"]["linear"])
    _linear(out, "final_layer.adaLN_modulation.1", p["final_layer"]["adaLN"])
    return out


def dit_from_jax_tree(tree, cfg) -> dit_mod.DiT:
    m = dit_mod.DiT(cfg)
    m.load_state_dict(dit_state_dict(tree, cfg), strict=True)
    return m


def dit_cross_attn_block_from_jax_tree(p, hidden, encoder_hidden, num_heads, mlp_ratio=4.0):
    out = {}
    _dit_block(out, "", p)
    for n in ("to_q", "kv", "proj"):
        _linear(out, "cross_attn." + n, p["cross_attn"][n])
    if "cross_mod" in p:
        _linear(out, "cross_modulation.1", p["cross_mod"])
    m = dit_mod.DiTCrossAttnBlock(hidden, encoder_hidden, num_heads, mlp_ratio,
                                  cross_modulate="cross_mod" in p)
    m.load_state_dict(out, strict=True)
    return m


def dit_dual_block_from_jax_tree(p, cfg) -> dit_mod.DiTDualBlock:
    out = {}
    a = p["attn"]
    for n in ("qkv", "query_linear", "proj", "query_proj", "to_query_kv"):
        if n in a:
            _linear(out, "attn." + n, a[n])
    if "gate" in a:
        out["attn.gate"] = _t(a["gate"])
    for n in ("q_norm", "k_norm", "query_qnorm", "query_knorm"):
        if n in a:
            _rmsnorm(out, "attn." + n, a[n])
    _mlp(out, "mlp", p["mlp"])
    _mlp(out, "q_mlp", p["q_mlp"])
    _linear(out, "adaLN_modulation.1", p["adaLN"])
    _linear(out, "adaLN_modulation_q.1", p["adaLN_q"])
    m = dit_mod.DiTDualBlock(cfg)
    m.load_state_dict(out, strict=True)
    return m


def clip_text_state_dict(p, cfg):
    """JAX CLIP tree -> reference (HF) named state dict."""
    out = {"text_model.embeddings.token_embedding.weight": _t(p["token_embedding"]),
           "text_model.embeddings.position_embedding.weight": _t(p["position_embedding"])}
    for i in range(cfg.num_hidden_layers):
        b = _unstack(p["layers"], i)
        pre = f"text_model.encoder.layers.{i}."
        _layernorm(out, pre + "layer_norm1", b["ln1"])
        _layernorm(out, pre + "layer_norm2", b["ln2"])
        for n, hf in (("q", "q_proj"), ("k", "k_proj"), ("v", "v_proj"), ("out", "out_proj")):
            _linear(out, pre + "self_attn." + hf, b["attn"][n])
        _mlp(out, pre + "mlp", b["mlp"])
    _layernorm(out, "text_model.final_layer_norm", p["final_layer_norm"])
    _linear(out, "text_projection", p["text_projection"])
    return out


def clip_text_from_jax_tree(tree, cfg) -> te.CLIPTextModel:
    m = te.CLIPTextModel(cfg)
    m.load_state_dict(clip_text_state_dict(tree, cfg), strict=True)
    return m


def t5_state_dict(p, cfg):
    """JAX T5 tree -> reference (HF) named state dict."""
    out = {"encoder.embed_tokens.weight": _t(p["embed_tokens"]),
           "encoder.block.0.layer.0.SelfAttention.relative_attention_bias.weight":
               _t(p["relative_attention_bias"])}
    for i in range(cfg.num_layers):
        b = _unstack(p["blocks"], i)
        pre = f"encoder.block.{i}.layer."
        _rmsnorm(out, pre + "0.layer_norm", b["attn_norm"])
        for n in ("q", "k", "v", "o"):
            _linear(out, pre + "0.SelfAttention." + n, b["attn"][n])
        _rmsnorm(out, pre + "1.layer_norm", b["ff_norm"])
        for n in ("wi_0", "wi_1", "wo"):
            _linear(out, pre + "1.DenseReluDense." + n, b["ff"][n])
    _rmsnorm(out, "encoder.final_layer_norm", p["final_layer_norm"])
    return out


def t5_from_jax_tree(tree, cfg) -> te.T5:
    m = te.T5(cfg)
    m.load_state_dict(t5_state_dict(tree, cfg), strict=True)
    return m


def tokenizer_state_dict(tree, tcfg: TokenizerConfig):
    """{'encoder': ..., ['model': ...]} of numpy leaves -> the reference-named
    state dict of the ImageTokenizer (``encoder.*``, ``model.*``)."""
    sd = {"encoder." + k: v
          for k, v in encoder_state_dict(tree["encoder"], tcfg.encoder).items()}
    if "model" in tree:
        sd.update({"model." + k: v
                   for k, v in mmdit_state_dict(tree["model"], tcfg.decoder).items()})
    return sd


def tokenizer_from_jax_tree(tree, tcfg: TokenizerConfig) -> ImageTokenizer:
    """{'encoder': ..., ['model': ...]} of numpy leaves -> ImageTokenizer
    (on the CPU, fp32; encode-only when the tree has no 'model')."""
    tok = ImageTokenizer(tcfg, encode_only="model" not in tree)
    tok.load_state_dict(tokenizer_state_dict(tree, tcfg), strict=True)
    return tok


def vq_state_from_jax(state) -> VQState:
    """The JAX package's VQState (a NamedTuple, numpy leaves) -> the port's
    (CPU tensors; steps int64, the two flags bool)."""
    return VQState(
        embed=_t(state.embed), cluster_size=_t(state.cluster_size),
        embed_avg=_t(state.embed_avg), timestep_p_over_c=_t(state.timestep_p_over_c),
        count=_t(state.count),
        steps=torch.tensor(int(np.asarray(state.steps)), dtype=torch.int64),
        initted=torch.tensor(bool(np.asarray(state.initted))),
        tpc_initted=torch.tensor(bool(np.asarray(state.tpc_initted))))


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


def _conv_bn(out, prefix, p):
    out[prefix + ".conv.weight"] = _t(np.asarray(p["w"]).transpose(3, 2, 0, 1))
    for name, leaf in (("weight", "bn_w"), ("bias", "bn_b"), ("running_mean", "bn_m"),
                       ("running_var", "bn_v")):
        out[f"{prefix}.bn.{name}"] = _t(p[leaf])


def inception_state_dict(tree):
    """The reference's Inception tree ({name: {'w' HWIO, 'bn_w', 'bn_b',
    'bn_m', 'bn_v'}}, the Mixed blocks one level deeper) -> torchvision
    names."""
    out = {}
    for name, node in tree.items():
        if "w" in node:
            _conv_bn(out, name, node)
        else:
            for branch, p in node.items():
                _conv_bn(out, f"{name}.{branch}", p)
    return out


def inception_from_jax_tree(tree, fid_variant=True) -> inception_mod.InceptionV3Pool3:
    """The reference's ``inception_init`` / ``inception_from_state_dict``
    tree -> InceptionV3Pool3 (CPU, fp32)."""
    model = inception_mod.InceptionV3Pool3(fid_variant=fid_variant)
    model.load_state_dict(inception_state_dict(tree), strict=True)
    return model


def lpips_state_dict(tree):
    """The reference's LPIPS tree ({'convs': {idx: {'w' HWIO, 'b'}}, 'lins':
    {i: [C]}}) -> the lpips package's names, with the scaling constants."""
    out = {"scaling_layer.shift": _t(lpips_mod.SHIFT)[None, :, None, None],
           "scaling_layer.scale": _t(lpips_mod.SCALE)[None, :, None, None]}
    for idx, p in tree["convs"].items():
        pre = f"net.slice{lpips_mod.slice_of(int(idx))}.{idx}"
        out[pre + ".weight"] = _t(np.asarray(p["w"]).transpose(3, 2, 0, 1))
        out[pre + ".bias"] = _t(p["b"])
    for i, w in tree["lins"].items():
        out[f"lin{i}.model.1.weight"] = _t(np.asarray(w).reshape(1, -1, 1, 1))
    return out


def lpips_from_jax_tree(tree) -> lpips_mod.LPIPS:
    """The reference's ``lpips_init`` / ``lpips_from_state_dict`` tree ->
    LPIPS (CPU, fp32)."""
    model = lpips_mod.LPIPS()
    model.load_state_dict(lpips_state_dict(tree), strict=True)
    return model
