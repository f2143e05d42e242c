"""The encode: ``SelftokPipeline.encoding`` (the VAE encoder, the encoder
trunk, the VQ's argmax) of images into ids, on a pipeline built
``encode_only``.

Driver options: ``precision`` (the pipeline's encode tier: highest, high
or default), ``checked_batches`` (how many of the pool's answered batches
the reference encodes again).
"""

from __future__ import annotations

import torch

from benchmark.harness import port, weights, yardstick
from benchmark.harness.serving import ServingDriver
from benchmark.reference import encoder as ref_enc
from benchmark.reference import vae as ref_vae
from benchmark.reference.nn import exact_fp32


class Driver(ServingDriver):
    def __init__(self, cell, seed, device, overrides=None):
        super().__init__(cell, seed, device, overrides)
        self.pipe = port.pipeline(self.cfg, seed, device, encode_only=True,
                                  encode_precision=self.opts["precision"])

    def _call(self, batch):
        return self.pipe.encoding(batch["images"])

    def work(self):
        """A call's model FLOPs by precision class (the VAE encoder in its
        configured type, the trunk and the scores fp32-exact at 'highest')
        and its argmax (N rows, C codes, D)."""
        if self.opts["precision"] != "highest":
            return None
        cfg, e = self.cfg, self.cfg["encoder"]
        B = self.images_per_call
        vae_class = {"bfloat16": "bf16", "float32": "fp32"}[cfg["vae"]["dtype"]]
        return {"flops": {vae_class: B * yardstick.vae_encoder_flops(cfg["image_size"], cfg["vae"]),
                          "fp32": B * yardstick.encoder_flops(e, cfg["image_size"])},
                "vq": (B * e["K"], e["codebook_size"], e["code_dim"])}

    def check(self):
        """The reference encodes the drawn batches again (the VAE in its
        configured type, the trunk and the scores in fp32 with TF32 off)
        from the same images and seeded weights. Compared: the share of ids
        that differ."""
        cfg = self.cfg
        sd = weights.tokenizer_weights(cfg, self.seed, self.device)
        vsd = weights.vae_weights(cfg, self.seed, self.device)
        vae_dtype = getattr(torch, cfg["vae"]["dtype"])
        differ = total = 0
        margin = float("inf")
        with torch.no_grad(), exact_fp32():
            for j in self.picks(self.opts["checked_batches"]):
                lat = ref_vae.images_to_latents(vsd, self.pool[j]["images"], vae_dtype)
                ids, margins = ref_enc.encode(sd, cfg["encoder"], lat)
                prog = self.kept[j].to(ids.device).long()
                wrong = prog != ids
                differ += int(wrong.sum())
                total += ids.numel()
                if wrong.any():
                    margin = min(margin, float(margins[wrong].max()))
        return ({"id_mismatch_share": differ / total},
                {"ids_compared": total, "widest_margin_of_a_differing_id":
                 None if margin == float("inf") else margin})
