"""The one-step renderer: ``SelftokPipeline.decoding_with_renderer`` (the
codebook context, one pass of the mask-token renderer, the VAE decode) on
id rows.

Driver options: ``dtype`` (the renderer's: bfloat16, float32 or int8),
``checked_batches`` (how many of the pool's answered batches the reference
renders again), ``latent_pool`` (the side, in latent pixels, of the windows
the compared latent is averaged over), ``vae`` (``"fp8"`` in the control:
the images judged are the reference VAE's in float8).
"""

from __future__ import annotations

import torch

from benchmark.harness import port, weights, yardstick
from benchmark.harness.serving import ServingDriver, vae_image_rel, worst_pooled_rel
from benchmark.reference import encoder as ref_enc
from benchmark.reference import mmdit as ref_mmdit
from benchmark.reference.nn import exact_fp32

POOL_WINDOWS = (1, 2, 4, 8, 16)     # the windows whose readings the information gives


class Driver(ServingDriver):
    def __init__(self, cell, seed, device, overrides=None):
        super().__init__(cell, seed, device, overrides)
        self.pipe = port.pipeline(self.cfg, seed, device, dtype=self.opts["dtype"])

    def _call(self, batch):
        return self.pipe.decoding_with_renderer(batch["ids"], return_latents=True)

    def work(self):
        """A call's model FLOPs by precision class and its attention calls
        [(B, H, Lq, Lk, D, item, active keys over the batch)]: a block's
        context rows over the K context keys, its latent rows over every
        key."""
        if self.opts["dtype"] != "bfloat16":
            return None
        cfg, d = self.cfg, self.cfg["decoder"]
        B, K = self.images_per_call, cfg["K"]
        mmdit, vae = yardstick.render_flops(cfg)
        n_x = (d["input_size"] // d["patch_size"]) ** 2
        H, hd = d["num_heads"], d["hidden_size"] // d["num_heads"]
        attn = [(B, H, K, K, hd, 2, B * K), (B, H, n_x, K + n_x, hd, 2, B * (K + n_x))]
        return {"flops": {"bf16": B * (mmdit + vae)}, "attention": attn * d["depth"]}

    def check(self):
        """Two stages, each against the reference from the same ids and
        seeded weights, for the drawn batches (the control, a lower precision
        of the program, is held to the reference of the cell's own):

        * ``latent_pooled_rel``: the renderer's latents against the
          reference's renderer (the codebook context, every block with both
          of its attentions) in the cell's configured type, each image's
          latent averaged over windows of ``latent_pool`` latent pixels: the
          worst image's RMS difference over its RMS. Any two bf16
          computations of the one-pass renderer part by about 1 % of the
          latent's RMS at full resolution (the rounding noise of the chain,
          white over the image), the int8 path by 2.5 %; a window's mean
          averages the noise down and keeps the int8 path's systematic
          part (every window's reading is in the information);
        * ``vae_image_rel``: the VAE stage by itself: the images against
          the reference's fp32 VAE decode of the program's own latents (the
          number above holds those latents).
        """
        cfg = self.cfg
        dt = weights.decoder_dtype(self.cell.options["driver_options"]["dtype"])
        sd = weights.tokenizer_weights(cfg, self.seed, self.device, decoder=dt)
        vsd = weights.vae_weights(cfg, self.seed, self.device)
        by_window = {w: 0.0 for w in sorted({*POOL_WINDOWS, self.opts["latent_pool"]})}
        img_err = 0.0
        with torch.no_grad(), exact_fp32():
            for j in self.picks(self.opts["checked_batches"]):
                images, latents = self.kept[j]
                ref = ref_mmdit.render(sd, cfg["decoder"], ref_enc.context(sd, self.pool[j]["ids"]), dt)
                for w in by_window:
                    by_window[w] = max(by_window[w], worst_pooled_rel(latents, ref, w))
                img_err = max(img_err, vae_image_rel(vsd, latents, images,
                                                     self.opts.get("vae") == "fp8"))
        return ({"latent_pooled_rel": by_window[self.opts["latent_pool"]], "vae_image_rel": img_err},
                {"latent_pooled_rel_by_window": by_window})
