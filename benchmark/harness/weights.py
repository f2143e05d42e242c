"""Seeded weights, made on the device from ``--seed`` by the benchmark itself.

The names and shapes of every leaf come from the configuration file's
groups (``encoder``, ``decoder``, ``vae``), under the names of the
tokenizer and SDVAE checkpoints, which both the program and the reference
read. Each of the three parts is one normal draw of a ``torch.Generator``
on the device, cut into the leaves and scaled by the leaf's rule; the norm
scales are ones and the sincos tables are computed. Every adaLN leaf is
non-zero: zero adaLN gates would switch every attention off.

Each part is made in the type it is served in (the decoder's in the
cell's decode type, bf16 for the int8 decoder too, which quantizes the
bf16 weights; the VAE's in its configured type; the encoder's in fp32), so
the program and the reference hold the same values. The same seed gives
the same tensors, so the reference can make them again once the program's
state is freed.
"""

from __future__ import annotations

import math

import torch

from benchmark.reference.nn import sincos_1d, sincos_2d

SMALL = 0.02        # biases, adaLN leaves, timestep embedders, learned tables


def _lin(spec, name, d_in, d_out, kind="matrix", bias=True):
    spec.append((name + ".weight", (d_out, d_in), kind))
    if bias:
        spec.append((name + ".bias", (d_out,), "bias"))


def _mlp(spec, name, d, ratio):
    _lin(spec, name + ".fc1", d, int(d * ratio))
    _lin(spec, name + ".fc2", int(d * ratio), d)


def _temb(spec, name, d, freq=256):
    _lin(spec, name + ".mlp.0", freq, d, "small")
    _lin(spec, name + ".mlp.2", d, d, "small")


def _norm(spec, name, c):
    spec.append((name + ".weight", (c,), "ones"))
    spec.append((name + ".bias", (c,), "bias"))


def encoder_spec(e):
    """The unidirectional dual encoder with its quantizer, ``encoder.*``."""
    if e["mode"] != "dual" or e["bidirectional"]:
        raise ValueError("the benchmark's encoder is the unidirectional dual form")
    s, P = [], "encoder."
    C, Cq, p = e["hidden_size"], e["query_dim"], e["patch_size"]
    s.append((P + "x_embedder.proj.weight", (C, e["in_channels"], p, p), "matrix"))
    s.append((P + "x_embedder.proj.bias", (C,), "bias"))
    s.append((P + "pos_embed", (1, e["pos_embed_max_size"] ** 2, C), f"sincos2d:{C}"))
    _norm(s, P + "final_layer_norm", Cq)
    _norm(s, P + "final_layer_norm2", e["code_dim"])
    _norm(s, P + "final_layer_norm3", e["encoder_hidden_size"])
    _lin(s, P + "quantizer.project_in", Cq, e["code_dim"])
    if e["encoder_hidden_size"] != e["code_dim"]:
        _lin(s, P + "quantizer.project_out", e["code_dim"], e["encoder_hidden_size"])
    s.append((P + "quantizer._codebook.embed", (1, e["codebook_size"], e["code_dim"]),
              "codebook"))
    s.append((P + "query_tokens", (1, e["K"], Cq), "small"))
    for i in range(e["depth"]):
        b = f"{P}blocks.{i}."
        _lin(s, b + "attn.qkv", C, 3 * C)
        _lin(s, b + "attn.query_linear", Cq, 3 * Cq)
        _lin(s, b + "attn.proj", C, C)
        _lin(s, b + "attn.query_proj", Cq, Cq)
        _lin(s, b + "attn.to_query_kv", C, 2 * Cq)
        _mlp(s, b + "mlp", C, e["mlp_ratio"])
        _mlp(s, b + "q_mlp", Cq, e["mlp_ratio"])
        _lin(s, b + "adaLN_modulation.1", Cq, 6 * Cq, "small")
        _temb(s, b + "t_embedder", Cq)
    return s


def decoder_spec(d, K):
    """MMDiT_XL, or with ``renderer`` its mask-token renderer, ``model.*``."""
    if d["time_adaln"] != "pos_emb":
        raise ValueError("the benchmark's decoder takes the 'pos_emb' context adaLN")
    s, P = [], "model."
    D, p, out = d["hidden_size"], d["patch_size"], d["in_channels"]
    _temb(s, P + "t_embedder", D)
    _lin(s, P + "context_embedder", d["encoder_hidden_size"], d["context_dim"])
    _lin(s, P + "final_layer.linear", D, p * p * out)
    _lin(s, P + "final_layer.adaLN_modulation.1", D, 2 * D, "small")
    if d["renderer"]:
        grid = d["input_size"] // p
        s.append((P + "positional_embedding", (grid * grid, D), f"std:{D ** -0.5}"))
        s.append((P + "mask_token", (1, 1 if d["repeat_mask_token"] else grid * grid, D),
                  f"std:{D ** -0.5}"))
    else:
        s.append((P + "x_embedder.proj.weight", (D, d["in_channels"], p, p), "matrix"))
        s.append((P + "x_embedder.proj.bias", (D,), "bias"))
        s.append((P + "pos_embed", (1, d["num_patches"], D), "small"))
    _temb(s, P + "y_embedder", D, freq=d["adm_in_channels"])
    s.append((P + "context_pos_embed", (1, K, d["context_dim"]), f"sincos1d:{d['context_dim']}"))
    for i in range(d["depth"]):
        last = i == d["depth"] - 1
        for stream in ("context_block", "x_block"):
            pre_only = last and stream == "context_block"
            b = f"{P}joint_blocks.{i}.{stream}."
            _lin(s, b + "attn.qkv", D, 3 * D, bias=d["qkv_bias"])
            if not pre_only:
                _lin(s, b + "attn.proj", D, D)
            _lin(s, b + "adaLN_modulation.1", D, (2 if pre_only else 6) * D, "small")
            if not pre_only:
                _mlp(s, b + "mlp", D, d["mlp_ratio"])
            if stream == "context_block" and not pre_only:
                _temb(s, b + "t_embedder", D)
    return s


def _resnet(s, name, cin, cout):
    _norm(s, name + ".norm1", cin)
    _conv(s, name + ".conv1", cin, cout, 3)
    _norm(s, name + ".norm2", cout)
    _conv(s, name + ".conv2", cout, cout, 3)
    if cin != cout:
        _conv(s, name + ".nin_shortcut", cin, cout, 1)


def _conv(s, name, cin, cout, k):
    s.append((name + ".weight", (cout, cin, k, k), "matrix"))
    s.append((name + ".bias", (cout,), "bias"))


def _mid(s, name, c):
    _resnet(s, name + ".block_1", c, c)
    _norm(s, name + ".attn_1.norm", c)
    for part in ("q", "k", "v", "proj_out"):
        _conv(s, f"{name}.attn_1.{part}", c, c, 1)
    _resnet(s, name + ".block_2", c, c)


def vae_spec(v):
    """The SD3 VAE, ``encoder.*`` and ``decoder.*``."""
    s = []
    ch, mult, nres = v["ch"], v["ch_mult"], v["num_res_blocks"]
    _conv(s, "encoder.conv_in", v["in_channels"], ch, 3)
    cin = ch
    for i, m in enumerate(mult):
        for j in range(nres):
            _resnet(s, f"encoder.down.{i}.block.{j}", cin, ch * m)
            cin = ch * m
        if i != len(mult) - 1:
            _conv(s, f"encoder.down.{i}.downsample.conv", cin, cin, 3)
    _mid(s, "encoder.mid", cin)
    _norm(s, "encoder.norm_out", cin)
    _conv(s, "encoder.conv_out", cin, 2 * v["z_channels"], 3)
    cin = ch * mult[-1]
    _conv(s, "decoder.conv_in", v["z_channels"], cin, 3)
    _mid(s, "decoder.mid", cin)
    for i in reversed(range(len(mult))):
        for j in range(nres + 1):
            _resnet(s, f"decoder.up.{i}.block.{j}", cin, ch * mult[i])
            cin = ch * mult[i]
        if i != 0:
            _conv(s, f"decoder.up.{i}.upsample.conv", cin, cin, 3)
    _norm(s, "decoder.norm_out", cin)
    _conv(s, "decoder.conv_out", cin, v["out_ch"], 3)
    return s


def _std(name, shape, kind):
    if kind == "matrix":
        fan_in = math.prod(shape[1:])
        return (1.0 / (3.0 * fan_in)) ** 0.5     # the variance of U(+-fan_in^-0.5)
    if kind in ("bias", "small"):
        return SMALL
    if kind.startswith("std:"):
        return float(kind[4:])
    raise ValueError(f"no rule for {name} ({kind})")


def make(spec, seed, device, dtype=torch.float32):
    """{name: tensor} of ``spec`` from one normal draw of a generator on
    ``device`` seeded with ``seed``, made in fp32 and given in ``dtype``."""
    drawn = [(n, sh, k) for n, sh, k in spec
             if k not in ("ones", "codebook") and not k.startswith("sincos")]
    codebooks = [(n, sh, k) for n, sh, k in spec if k == "codebook"]
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    total = sum(math.prod(sh) for _, sh, _ in drawn + codebooks)
    flat = torch.randn(total, generator=gen, device=device, dtype=torch.float32)
    out, at = {}, 0
    for name, shape, kind in drawn + codebooks:
        n = math.prod(shape)
        t = flat[at:at + n].view(shape)
        at += n
        if kind == "codebook":
            t /= torch.linalg.vector_norm(t, dim=-1, keepdim=True).clamp_(min=1e-12)
        else:
            t *= _std(name, shape, kind)
        out[name] = t
    for name, shape, kind in spec:
        if kind == "ones":
            out[name] = torch.ones(shape, device=device)
        elif kind.startswith("sincos2d"):
            dim = int(kind.split(":")[1])
            grid = int(round(shape[1] ** 0.5))
            out[name] = torch.tensor(sincos_2d(dim, grid), dtype=torch.float32,
                                     device=device)[None]
        elif kind.startswith("sincos1d"):
            dim = int(kind.split(":")[1])
            pos = 1000.0 + 8.0 * torch.arange(shape[1], dtype=torch.float64)
            out[name] = torch.tensor(sincos_1d(dim, pos.numpy().astype("float32")),
                                     dtype=torch.float32, device=device)[None]
    if dtype == torch.float32:
        return {name: out[name] for name, _, _ in spec}
    del flat
    return {name: out.pop(name).to(dtype) for name, _, _ in spec}


# one seed per part, so a part is made again alone
_PARTS = {"encoder": 1, "decoder": 2, "vae": 3}


def part_seed(seed, part):
    return (int(seed) * 4 + _PARTS[part]) % (2 ** 63 - 1)


def decoder_dtype(decode_dtype):
    """The type the decoder's weights are served in for a decode type."""
    return torch.float32 if decode_dtype == "float32" else torch.bfloat16


def tokenizer_weights(cfg, seed, device, encoder=True, decoder=None):
    """The tokenizer's state dict (``encoder.*`` in fp32; ``model.*`` in
    ``decoder``, a torch dtype, unless None) of the configuration on
    ``device``."""
    sd = {}
    if encoder:
        sd.update(make(encoder_spec(cfg["encoder"]), part_seed(seed, "encoder"), device))
    if decoder is not None:
        sd.update(make(decoder_spec(cfg["decoder"], cfg["K"]), part_seed(seed, "decoder"), device,
                       decoder))
    return sd


def vae_weights(cfg, seed, device):
    """The VAE's state dict in its configured type."""
    return make(vae_spec(cfg["vae"]), part_seed(seed, "vae"), device,
                getattr(torch, cfg["vae"]["dtype"]))
