"""The system under test: the PyTorch / CUDA port's pipeline, built from the
configuration file and given the benchmark's seeded weights."""

from __future__ import annotations

import torch

from benchmark.harness import weights

DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32, "int8": "int8"}


def pipeline(cfg, seed, device, dtype="bfloat16", encode_only=False, encode_precision="highest"):
    """``SelftokPipeline`` of the configuration, with the weights of
    ``harness/weights.py`` from ``seed`` loaded strictly."""
    from selftoktokenizer_tpu_torch.core.config import AttrDict
    from selftoktokenizer_tpu_torch.models.tokenizer import tokenizer_from_state_dict
    from selftoktokenizer_tpu_torch.models.vae import vae_from_state_dict
    from selftoktokenizer_tpu_torch.pipeline.pipeline import SelftokPipeline

    pipe = SelftokPipeline(
        AttrDict({"tokenizer": {"params": cfg["tokenizer_params"]}}),
        datasize=cfg["image_size"], steps=cfg["decode_steps"], cfg_scale=cfg["cfg_scale"],
        decode_dtype=DTYPES[dtype], encode_precision=encode_precision,
        encode_only=encode_only, device=device)
    sd = weights.tokenizer_weights(
        cfg, seed, device, decoder=None if encode_only else weights.decoder_dtype(dtype))
    tok, _ = tokenizer_from_state_dict(sd, pipe.tcfg, encode_only=encode_only)
    del sd
    vae = vae_from_state_dict(weights.vae_weights(cfg, seed, device))
    pipe.set_weights(tok, vae)
    return pipe

