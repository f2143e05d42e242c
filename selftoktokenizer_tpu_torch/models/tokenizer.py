"""ImageTokenizer composite: config assembly, the module that holds the
encoder and the decoder, reference state-dict loading and the training loss
graphs, and the multi-resolution tokenizer's loss (counterpart of the
reference ``models/tokenizer.py``). The YAML
``tokenizer.params`` schema of the reference configs is consumed unchanged.

The losses take every random draw of the reference as an optional input
(``t``, ``noise``, ``drop_ids`` and the quantizer's draws); what is not
given is drawn from the ``torch.Generator`` passed as ``rng``.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch
from torch import nn

from selftoktokenizer_tpu_torch.core.config import none_str as _none
from selftoktokenizer_tpu_torch.models import flow as flow_mod
from selftoktokenizer_tpu_torch.models import vq as vq_mod
from selftoktokenizer_tpu_torch.models.diti import make_diti
from selftoktokenizer_tpu_torch.models.encoder import (
    EncoderConfig, QformerEncoder, _embed_patches, encoder_apply, get_encoder_mask,
    get_encoder_outs, patches_per_token)
from selftoktokenizer_tpu_torch.models.dit import DiT
from selftoktokenizer_tpu_torch.models.mmdit import (
    MMDiT, MMDiTConfig, mmdit_apply, renderer_apply)
from selftoktokenizer_tpu_torch.ops.norms import layer_norm
from selftoktokenizer_tpu_torch.models.zoo import (
    build_decoder_config, build_encoder_config)


@dataclasses.dataclass
class TokenizerConfig:
    encoder: EncoderConfig
    decoder: MMDiTConfig
    k: int
    t2k: float
    stages: Optional[str]
    k_per_stage: Optional[str]
    k_m: Optional[float]
    k_s: Optional[float]
    image_size: int
    context_see_xt: bool
    diffusion: dict                  # noise_schedule_config
    quantizer: dict                  # quantizer_config
    enc_name: str = ""
    model_name: str = ""

    @property
    def latent_size(self):
        return self.image_size // 8

    def make_diti(self):
        return make_diti(self.k, self.stages, self.k_per_stage,
                         self.k_m, self.k_s)


def tokenizer_config_from_params(params) -> TokenizerConfig:
    """Build from the YAML ``tokenizer.params`` mapping."""
    p = dict(params)
    image_size = p["image_size"]
    latent_size = image_size // 8
    k = p["k"]
    enc = p["enc"]
    stages = _none(p.get("stages"))
    enc_cfg_in = dict(p.get("encoder_config", {}))
    dec_cfg_in = dict(p.get("decoder_config", {}))
    qcfg = dict(p.get("quantizer_config", {}))

    # the diti is injected into encoder and decoder only for Qformer +
    # enable_enc_variable_size; without it the blocks fall back to arange
    # positions for adaLN
    has_diti = "Qformer" in enc and p.get("enable_enc_variable_size", False)
    if has_diti:
        enc_cfg_in["pos_embed_max_size"] = 2 * latent_size

    encoder = build_encoder_config(
        enc, K=k, input_size=latent_size,
        encoder_hidden_size=p["encoder_hidden_size"],
        in_channels=p.get("in_channels", 16),
        quantizer_config=qcfg, encoder_config=enc_cfg_in,
        diti_positions=has_diti)
    decoder = build_decoder_config(
        p["model"], K=k, input_size=latent_size,
        encoder_hidden_size=p["encoder_hidden_size"],
        in_channels=p.get("in_channels", 16), decoder_config=dec_cfg_in,
        diti_positions=has_diti)
    if p.get("gradient_checkpointing", False):
        encoder.gradient_checkpointing = True
        decoder.use_checkpoint = True
    return TokenizerConfig(
        encoder=encoder, decoder=decoder, k=k, t2k=p.get("t2k", 1.0),
        stages=stages, k_per_stage=_none(p.get("k_per_stage")),
        k_m=p.get("k_m"), k_s=p.get("k_s"), image_size=image_size,
        context_see_xt=p.get("context_see_xt", False),
        diffusion=dict(p.get("noise_schedule_config", {})),
        quantizer=qcfg, enc_name=enc, model_name=p["model"])


class ImageTokenizer(nn.Module):
    """``encoder.*`` and ``model.*``, the two halves of a reference
    checkpoint. ``encode_only`` leaves the 2B-parameter decoder out."""

    def __init__(self, cfg: TokenizerConfig, encode_only=False):
        super().__init__()
        self.cfg = cfg
        self.encoder = QformerEncoder(cfg.encoder)
        self.model = None if encode_only else MMDiT(cfg.decoder)

    def run(self, fn, *args, **kwargs):
        """fn(self, *args, **kwargs). The trainer reaches the module's
        weights inside this call: under FSDP (``parallel.mesh``) it is the
        forward that gathers the parameters of the module's own group."""
        return fn(self, *args, **kwargs)


def _uniform_(t, bound, generator):
    t.uniform_(-bound, bound, generator=generator)


@torch.no_grad()
def init_weights_(module: nn.Module, generator: torch.Generator,
                  zero_init_std: float = 0.0):
    """Seeded init of every leaf, by the reference's scheme: uniform
    fan-in bounds for matrices and conv kernels, std-0.02 normals for the
    timestep embedders and the query tokens, std hidden^-0.5 normals for the
    renderer's mask token and positional embedding, an l2-normalised
    codebook, norm weights one, the sincos position tables as built. It
    takes any module of the port (the encoders, MMDiT, DiT, the text
    encoders), whose embedding tables get the matrices' rule.

    The reference zero-initialises every adaLN projection, every bias and
    the zero-init encoder's ``gate`` (tanh(0) closes its image part), which
    closes every attention gate: the attention output then never
    reaches the result. ``zero_init_std > 0`` fills those leaves (and the
    MMDiT's learned pos_embed) with normals of that std instead, so a run on
    random weights exercises the whole graph.
    """
    for name, t in module.named_parameters():
        leaf = name.rsplit(".", 1)[-1]
        parent = name.rsplit(".", 1)[0] if "." in name else ""
        owner = module.get_submodule(parent)
        zero = False
        if leaf in ("context_pos_embed", "low_res_hidden_pos_embed") or (
                leaf == "pos_embed" and isinstance(owner, (QformerEncoder, DiT))):
            continue                          # sincos tables, as built
        if name.endswith("_codebook.embed"):
            t.normal_(generator=generator)
            t.div_(torch.linalg.vector_norm(t, dim=-1, keepdim=True).clamp_(min=1e-12))
        elif leaf == "query_tokens":
            t.normal_(std=0.02, generator=generator)
        elif leaf == "register":
            t.normal_(generator=generator)
        elif leaf in ("positional_embedding", "mask_token"):
            t.normal_(std=t.shape[-1] ** -0.5, generator=generator)   # the renderer's
        elif leaf == "pos_embed":
            zero = True
        elif "adaLN_modulation" in parent or leaf == "gate":
            zero = True
        elif leaf == "bias":
            zero = True
        elif leaf == "weight" and t.ndim == 1:
            t.fill_(1.0)                      # norm scales
        elif leaf == "weight" and "t_embedder.mlp" in parent:
            t.normal_(std=0.02, generator=generator)
        elif leaf == "weight":
            fan_in = t[0].numel()
            _uniform_(t, (1.0 / fan_in) ** 0.5, generator)
        else:
            raise ValueError(f"init_weights_: no rule for {name}")
        if zero:
            if zero_init_std > 0:
                t.normal_(std=zero_init_std, generator=generator)
            else:
                t.zero_()


def tokenizer_from_state_dict(sd, cfg: TokenizerConfig, encode_only=False):
    """A reference ImageTokenizer / ImageRenderer state dict (``encoder.*``
    and ``model.*``, optional ``module.`` prefixes) -> (ImageTokenizer on the
    CPU in fp32, loaded strictly; the quantizer's VQState when the dict holds
    its EMA buffers, else None). ``encode_only`` reads the encoder alone;
    keys outside the two halves are not read."""
    sd = {k[len("module."):] if k.startswith("module.") else k: v for k, v in sd.items()}
    with torch.device("meta"):
        tok = ImageTokenizer(cfg, encode_only=encode_only)
    own = set(tok.state_dict())
    q = "encoder.quantizer."
    halves = ("encoder.",) if encode_only else ("encoder.", "model.")
    load = {k: v.float() if v.is_floating_point() else v for k, v in sd.items()
            if k in own or (k.startswith(halves) and not k.startswith(q))}
    tok.load_state_dict(load, strict=True, assign=True)
    buffers = {k[len(q):]: v for k, v in sd.items() if k.startswith(q) and k not in own}
    vq_state = None
    if buffers:
        buffers["_codebook.embed"] = sd[q + "_codebook.embed"]
        vq_state = vq_mod.vq_state_from_state_dict(buffers, cfg.k)
    return tok, vq_state


# ---------------------------------------------------------------------------
# training losses
# ---------------------------------------------------------------------------

def pre_vq_outs(p: QformerEncoder, cfg: TokenizerConfig, x):
    """Encoder trunk up to the quantizer input: (outs [B,K,hidden], x_emb)."""
    x_emb = _embed_patches(p, cfg.encoder, x)
    outs = get_encoder_outs(p, cfg.encoder, x_emb)
    if cfg.encoder.pre_norm:
        outs = layer_norm(outs, p.final_layer_norm.weight, p.final_layer_norm.bias)
    return outs, x_emb


def resolution_shift(latent_h, latent_w):
    """Resolution-dependent flow shift: 1.0 below 2048 latent pixels, 1.878
    at and above."""
    return 1.0 if (latent_h * latent_w / 4096.0) < 0.5 else 1.878


def loss_draws(cfg: TokenizerConfig, shape, device, rng=None, t=None, noise=None,
               drop_ids=None, dtype=torch.float32):
    """The loss's draws for a batch of ``shape``: t [B] (uniform, before the
    shift), noise (normal, of ``shape``) and drop_ids [B] (None without CFG
    drop); those given, the rest drawn from rng in this order."""
    B = shape[0]
    drop_p = cfg.decoder.class_dropout_prob
    if rng is None and (t is None or noise is None or (drop_ids is None and drop_p > 0)):
        raise ValueError("pass rng (a torch.Generator) or t, noise and drop_ids")
    if t is None:
        t = torch.rand((B,), generator=rng, device=device)
    if noise is None:
        noise = torch.randn(shape, generator=rng, device=device, dtype=dtype)
    if drop_ids is None and drop_p > 0:
        drop_ids = torch.rand((B,), generator=rng, device=device) < drop_p
    return t.to(device), noise.to(device), None if drop_ids is None else drop_ids.to(device)


def tokenizer_loss(tok: ImageTokenizer, cfg: TokenizerConfig, x, rng=None, vq_state=None,
                   full_tokens=False, train_quantizer=True, ema_encoder=None, L2_lr=0.0,
                   t=None, noise=None, drop_ids=None, gumbel_noise=None, kmeans_idx=None,
                   react_uniforms=None, warm_ids=None, vq_injected=None):
    """Training forward: sample t, map it to a token depth, encode and
    quantize, flow-matching loss with the CFG condition drop.

    x: NHWC latents [B,h,w,C]. rng: a torch.Generator for the draws not
    passed in: t [B] (uniform, before the shift), noise (x-shaped normal),
    drop_ids [B] bool, and the quantizer's (``vq.vq_train_apply``).
    ema_encoder: a QformerEncoder holding an EMA copy of the encoder, for
    the L2 anchor weighted by L2_lr. vq_injected: the accumulated step's
    frozen global quantities ({"ids", "embed_used", "g_ap"}, see
    ``vq.vq_microbatch_surrogate``), which replace the quantizer; the VQ
    state then does not advance here. Returns (loss, aux) with
    aux['vq_state'] the new VQ state, aux['log_dict'] and aux['ids']."""
    B, h, w, _ = x.shape
    dev = x.device
    shift = resolution_shift(h, w)
    diti = cfg.make_diti()
    t, noise, drop_ids = loss_draws(cfg, x.shape, dev, rng, t, noise, drop_ids, x.dtype)

    scale = 1000.0 if cfg.stages is not None else 1.0
    if full_tokens:
        k_batch = diti.to_indices(torch.ones_like(t) * scale)
    else:
        k_batch = diti.to_indices(torch.clamp(cfg.t2k * t, 0, 1.0) * scale)
    t = flow_mod.shift_t(t, shift)

    enc = tok.encoder
    outs, x_emb = pre_vq_outs(enc, cfg, x)
    if vq_injected is not None:
        outs_q, quan_loss, vq_logs = vq_mod.vq_microbatch_surrogate(
            enc.quantizer, outs, vq_injected, cfg.quantizer)
        ids, new_vq_state = vq_injected["ids"], vq_state
    elif train_quantizer and vq_state is not None:
        outs_q, ids, quan_loss, new_vq_state, vq_logs = vq_mod.vq_train_apply(
            enc.quantizer, vq_state, outs, cfg.quantizer, rng=rng, gumbel_noise=gumbel_noise,
            kmeans_idx=kmeans_idx, react_uniforms=react_uniforms, warm_ids=warm_ids)
    else:
        outs_q, ids, quan_loss, vq_logs = vq_mod.vq_apply(enc.quantizer, outs)
        new_vq_state = vq_state
    if cfg.encoder.post_norm:
        outs_q = layer_norm(outs_q, enc.final_layer_norm3.weight, enc.final_layer_norm3.bias)

    # a plain-ViT encoder's K tokens are groups of patches: the mask repeats
    # per patch
    enc_mask = get_encoder_mask(cfg.encoder, k_batch.to(dev),
                                patches_per_token(cfg.encoder, x_emb))
    ehs = outs_q * enc_mask[..., None].to(outs_q.dtype)

    def model_fn(x_t, tt):
        return mmdit_apply(tok.model, cfg.decoder, x_t, tt, ehs, mask=enc_mask,
                           context_see_xt=cfg.context_see_xt, drop_ids=drop_ids)

    terms = flow_mod.training_losses(
        model_fn, x, t, noise,
        parameterization=cfg.diffusion.get("parameterization", "velocity"),
        force_recon=cfg.diffusion.get("force_recon", False), drop_ids=drop_ids)
    batch_mse = torch.mean(terms["loss"])
    loss = batch_mse + quan_loss

    if ema_encoder is not None and L2_lr > 0:
        # pull the pre-VQ features toward the EMA encoder's, leaving out each
        # row's last active token
        with torch.no_grad():
            ema_outs, _ = pre_vq_outs(ema_encoder, cfg, x)
        last_idx = torch.sum(enc_mask, dim=1) - 1
        l2_mask = enc_mask & (torch.arange(enc_mask.shape[1], device=dev)[None, :]
                              != last_idx[:, None])
        m = l2_mask[..., None].to(outs.dtype)
        loss = loss + L2_lr * torch.mean((outs * m - ema_outs * m) ** 2)

    log_dict = {
        "loss": loss.detach(), "dm_mse": batch_mse.detach(),
        "loss_small": terms["small"].detach(), "loss_mid": terms["mid"].detach(),
        "loss_large": terms["large"].detach(), "loss_uncon": terms["uncon"].detach(),
        **{f"vq_{k}": v for k, v in vq_logs.items()},
    }
    return loss, {"vq_state": new_vq_state, "log_dict": log_dict, "ids": ids}


def renderer_loss(tok: ImageTokenizer, cfg: TokenizerConfig, x):
    """ImageRenderer forward: every token active, one-step reconstruction.
    Returns (ids, the quantized hidden states, pred_x0)."""
    B = x.shape[0]
    d = torch.full((B,), cfg.k - 1, dtype=torch.int32, device=x.device)
    ehs, _, ori_hidden, mask, _, _, ids = encoder_apply(tok.encoder, cfg.encoder, x, d=d)
    pred_x0 = renderer_apply(tok.model, cfg.decoder, ehs, mask=mask)
    return ids, ori_hidden, pred_x0


def renderer_train_loss(model: MMDiT, encoder: QformerEncoder, cfg: TokenizerConfig, x):
    """The one-step renderer's training loss against a frozen tokenizer: the
    tokens come from ``encoder`` without gradient, only the renderer MMDiT
    learns. Returns (loss, log_dict) with the batch's code-usage
    perplexity."""
    B = x.shape[0]
    d = torch.full((B,), cfg.k - 1, dtype=torch.int32, device=x.device)
    with torch.no_grad():
        ehs, _, _, mask, _, _, ids = encoder_apply(encoder, cfg.encoder, x, d=d)
    pred_x0 = renderer_apply(model, cfg.decoder, ehs, mask=mask)
    loss = torch.mean((pred_x0 - x) ** 2)
    counts = torch.bincount(ids.reshape(-1).long(), minlength=cfg.encoder.codebook_size).float()
    p = counts / torch.clamp(torch.sum(counts), min=1)
    ppl = torch.exp(-torch.sum(p * torch.log(p + 1e-10)))
    return loss, {"loss": loss.detach(), "recon_mse": loss.detach(), "batch_perplexity": ppl}


# ---------------------------------------------------------------------------
# the multi-resolution tokenizer
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class MultiTokenizerConfig:
    """A dict of per-resolution encoders feeding one decoder with the token
    streams interleaved. The reference's own implementation cannot run (it
    unpacks a 5-tuple from an encoder that returns 7 and indexes shapes as
    dicts); this is the loss graph it intends, as the JAX package has it."""
    encoders: dict                     # resolution name -> EncoderConfig
    decoder: MMDiTConfig
    k: int
    stages: Optional[str]
    k_per_stage: Optional[str]
    image_size: int
    train_encoder_res: str
    diffusion: dict
    quantizer: dict

    def make_diti(self):
        return make_diti(self.k, self.stages, self.k_per_stage, None, None)


class MultiImageTokenizer(nn.Module):
    """``encoder.<resolution>.*`` (one QformerEncoder each) and ``model.*``
    (the MMDiT over the K * R interleaved tokens)."""

    def __init__(self, cfg: MultiTokenizerConfig):
        super().__init__()
        self.cfg = cfg
        self.encoder = nn.ModuleDict({res: QformerEncoder(ec) for res, ec in cfg.encoders.items()})
        self.model = MMDiT(cfg.decoder)


def multi_tokenizer_loss(tok: MultiImageTokenizer, cfg: MultiTokenizerConfig, batch, rng=None,
                         vq_states=None, full_tokens=False, t=None, noise=None, vq_draws=None):
    """The multi-resolution tokenizer's training loss. batch: resolution
    name -> NHWC latents; ``cfg.train_encoder_res`` names the diffusion
    target, whose size sets the flow shift. Each encoder makes K tokens; the
    streams are interleaved token-major (stacked on dim 2, then flattened)
    into a K * R context, and the MMDiT sees it with ``context_see_xt``.

    Every draw is an input: t [B] (uniform, before the shift), noise (the
    target's shape, normal) and vq_draws, resolution name -> the keyword
    draws of ``vq.vq_train_apply`` (kmeans_idx, react_uniforms,
    gumbel_noise, warm_ids); what is not given comes from rng, a
    torch.Generator. vq_states: resolution name -> VQState; with a state
    the resolution's quantizer trains (EMA update, commitment and
    diversity losses), without one it is the eval ``vq_apply``.
    full_tokens: every token active. Returns (loss, {"log_dict",
    "vq_states"}), the new states keyed by resolution (None where none was
    given)."""
    x = batch[cfg.train_encoder_res]
    B, h, w, _ = x.shape
    dev = x.device
    if rng is None and (t is None or noise is None):
        raise ValueError("pass rng (a torch.Generator) or t and noise")
    if t is None:
        t = torch.rand((B,), generator=rng, device=dev)
    if noise is None:
        noise = torch.randn(x.shape, generator=rng, device=dev, dtype=x.dtype)
    t, noise = t.to(dev), noise.to(dev)
    diti = cfg.make_diti()
    k_batch = diti.to_indices((torch.ones_like(t) if full_tokens else t) * 1000.0).to(dev)
    t = flow_mod.shift_t(t, resolution_shift(h, w))

    ehs_list, mask_list, new_states, log_dict = [], [], {}, {}
    quan_loss = 0.0
    for res, ecfg in cfg.encoders.items():
        enc = tok.encoder[res]
        outs = get_encoder_outs(enc, ecfg, _embed_patches(enc, ecfg, batch[res]))
        if ecfg.pre_norm:
            outs = layer_norm(outs, enc.final_layer_norm.weight, enc.final_layer_norm.bias)
        st = vq_states.get(res) if vq_states else None
        if st is not None:
            draws = (vq_draws or {}).get(res, {})
            outs_q, _, ql, new_st, vq_logs = vq_mod.vq_train_apply(
                enc.quantizer, st, outs, cfg.quantizer, rng=rng, **draws)
        else:
            outs_q, _, ql, vq_logs = vq_mod.vq_apply(enc.quantizer, outs)
            new_st = None
        if ecfg.post_norm:
            outs_q = layer_norm(outs_q, enc.final_layer_norm3.weight, enc.final_layer_norm3.bias)
        enc_mask = get_encoder_mask(ecfg, k_batch)
        ehs_list.append(outs_q * enc_mask[..., None].to(outs_q.dtype))
        mask_list.append(enc_mask)
        quan_loss = quan_loss + ql
        log_dict[f"vq_{res}"] = vq_logs
        new_states[res] = new_st
    ehs = torch.stack(ehs_list, dim=2).reshape(B, -1, ehs_list[0].shape[-1])
    mask = torch.stack(mask_list, dim=2).reshape(B, -1)

    def model_fn(x_t, tt):
        return mmdit_apply(tok.model, cfg.decoder, x_t, tt, ehs, mask=mask, context_see_xt=True)

    terms = flow_mod.training_losses(
        model_fn, x, t, noise, parameterization=cfg.diffusion.get("parameterization", "velocity"))
    loss = torch.mean(terms["loss"]) + quan_loss
    log_dict["loss"] = loss.detach()
    log_dict["mse"] = torch.mean(terms["mse"]).detach()
    return loss, {"log_dict": log_dict, "vq_states": new_states}
