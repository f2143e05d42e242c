"""ImageTokenizer composite: config assembly and the module that holds the
encoder and the decoder (counterpart of the reference
``models/tokenizer.py:32-103``). The YAML ``tokenizer.params`` schema of the
reference configs is consumed unchanged.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch
from torch import nn

from selftoktokenizer_tpu_torch.core.config import none_str as _none
from selftoktokenizer_tpu_torch.models.diti import make_diti
from selftoktokenizer_tpu_torch.models.encoder import EncoderConfig, QformerEncoder
from selftoktokenizer_tpu_torch.models.mmdit import MMDiT, MMDiTConfig
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


def _uniform_(t, bound, generator):
    t.uniform_(-bound, bound, generator=generator)


@torch.no_grad()
def init_weights_(module: nn.Module, generator: torch.Generator,
                  zero_init_std: float = 0.0):
    """Seeded init of every leaf, by the reference's scheme: uniform
    fan-in bounds for matrices and conv kernels, std-0.02 normals for the
    timestep embedders and the query tokens, std hidden^-0.5 normals for the
    renderer's mask token and positional embedding, an l2-normalised
    codebook, norm weights one.

    The reference zero-initialises every adaLN projection and every bias,
    which closes every attention gate: the attention output then never
    reaches the result. ``zero_init_std > 0`` fills those leaves (and the
    MMDiT's learned pos_embed) with normals of that std instead, so a run on
    random weights exercises the whole graph.
    """
    for name, t in module.named_parameters():
        leaf = name.rsplit(".", 1)[-1]
        parent = name.rsplit(".", 1)[0] if "." in name else ""
        zero = False
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
        elif "adaLN_modulation" in parent:
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
