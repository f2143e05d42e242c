"""The diffusion decode: ``SelftokPipeline.decoding`` (codebook context, the
50-step Euler sampler over the MMDiT with its context buckets, the VAE
decode) on id rows and start noise.

Driver options: ``dtype`` (the decoder's: bfloat16, float32 or int8),
``checked_batches`` (how many of the pool's answered batches the reference
decodes again), ``vae`` (``"fp8"`` in the control: the images judged are
the reference VAE's in float8).
"""

from __future__ import annotations

import torch

from benchmark.harness import port, weights, yardstick
from benchmark.harness.serving import ServingDriver, vae_image_rel, worst_relative_rms
from benchmark.reference import encoder as ref_enc
from benchmark.reference import mmdit as ref_mmdit
from benchmark.reference.nn import exact_fp32


class Driver(ServingDriver):
    def __init__(self, cell, seed, device, overrides=None):
        super().__init__(cell, seed, device, overrides)
        self.pipe = port.pipeline(self.cfg, seed, device, dtype=self.opts["dtype"])

    def _call(self, batch):
        return self.pipe.decoding(batch["ids"], noise=batch["noise"], return_latents=True)

    # ---------------------------------------------------------- accounting

    def _steps(self):
        cfg = self.cfg
        _, _, tm = ref_mmdit.schedule(cfg["decode_steps"])
        step_k = ref_mmdit.step_tokens(cfg["diti"], cfg["K"], tm)
        ctx = {}
        for s, e, Lc in ref_mmdit.buckets(step_k, cfg["K"]):
            for i in range(s, e):
                ctx[i] = Lc
        return [(ctx[i], int(step_k[i]) + 1) for i in range(len(step_k))]

    def work(self):
        """A call's model FLOPs by precision class, its attention calls
        [(B, H, Lq, Lk, D, item, active keys over the batch)] and its
        sampler steps."""
        if self.opts["dtype"] != "bfloat16":
            return None
        cfg, d = self.cfg, self.cfg["decoder"]
        B = self.images_per_call
        steps = self._steps()
        mmdit, vae = yardstick.decode_flops(cfg, [Lc for Lc, _ in steps])
        n_x = (cfg["image_size"] // 8 // d["patch_size"]) ** 2
        attn = []
        for Lc, active in steps:
            L = Lc + n_x
            attn += [(B, d["num_heads"], L, L, d["hidden_size"] // d["num_heads"], 2,
                      B * (active + n_x))] * d["depth"]
        return {"flops": {"bf16": B * (mmdit + vae)}, "attention": attn,
                "steps": len(steps)}

    # --------------------------------------------------------------- check

    def check(self):
        """Two stages, each against the reference from the same ids, noise
        and seeded weights, for the drawn batches (the control, a lower
        precision of the program, is held to the reference of the cell's
        own):

        * ``latent_rms_rel``: the sampler's final latents against the
          reference's sampler (the codebook context, every MMDiT block,
          every step with its bucket), its decoder in the cell's configured
          type and the rest in fp32 with TF32 off: the worst image's RMS
          difference over its RMS;
        * ``vae_image_rel``: the VAE stage by itself: the images against
          the reference's fp32 VAE decode of the program's own latents (the
          number above holds those latents).
        """
        cfg = self.cfg
        dt = weights.decoder_dtype(self.cell.options["driver_options"]["dtype"])
        sd = weights.tokenizer_weights(cfg, self.seed, self.device, decoder=dt)
        vsd = weights.vae_weights(cfg, self.seed, self.device)
        lat_err = img_err = 0.0
        with torch.no_grad(), exact_fp32():
            for j in self.picks(self.opts["checked_batches"]):
                b = self.pool[j]
                images, latents = self.kept[j]
                ref = ref_mmdit.sample(sd, cfg["decoder"], cfg["diti"], cfg["K"],
                                       cfg["decode_steps"], ref_enc.context(sd, b["ids"]),
                                       b["noise"], dt)
                lat_err = max(lat_err, worst_relative_rms(latents, ref))
                img_err = max(img_err, vae_image_rel(vsd, latents, images,
                                                     self.opts.get("vae") == "fp8"))
        return {"latent_rms_rel": lat_err, "vae_image_rel": img_err}, {}
