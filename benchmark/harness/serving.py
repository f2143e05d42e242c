"""What the serving drivers share: a pool of batches from the traffic mix,
the program's answers kept for the check, and the draw of the answers that
the check compares."""

from __future__ import annotations

import gc
import random

import torch

from benchmark.harness import traffic as traffic_mod
from benchmark.reference import vae as ref_vae


class ServingDriver:
    """A closed-loop caller over a pool of batches. Subclasses set
    ``self.pipe`` and define ``_call(batch)`` (the timed entry) and the
    reference side of ``check``."""

    images_per_call = None

    def __init__(self, cell, seed, device, overrides=None):
        self.cell, self.seed, self.device = cell, seed, device
        self.cfg = cell.config
        self.opts = dict(cell.options.get("driver_options", {}), **(overrides or {}))
        self.pool = traffic_mod.make(cell.traffic, self.cfg, seed, device)
        self.images_per_call = cell.traffic["batch"]
        self.kept = {}

    def warm(self):
        """One call on each shape the traffic uses (one: every batch of the
        pool has the same), ended by a synchronize."""
        self._call(self.pool[0])
        if self.device != "cpu":
            torch.cuda.synchronize()

    def call(self, i):
        j = i % len(self.pool)
        self.kept[j] = self._call(self.pool[j])

    def picks(self, n):
        """``n`` of the pool's batches that the window answered, drawn from
        the seed, or all of them when fewer were answered."""
        done = sorted(self.kept)
        rng = random.Random(int(self.seed) * 7919 + 17)
        return done if n >= len(done) else sorted(rng.sample(done, n))

    def release(self):
        """Free the program's state; the kept answers move to the host."""
        self.kept = {j: tuple(t.cpu() for t in v) if isinstance(v, tuple) else v.cpu()
                     for j, v in self.kept.items()}
        self.pipe = None
        gc.collect()
        if self.device != "cpu":
            torch.cuda.empty_cache()


def worst_relative_rms(program, reference):
    """The largest RMS difference of one row between two batches, relative
    to that row's RMS in the reference."""
    ref = reference.float().to(program.device).reshape(program.shape[0], -1)
    d = program.float().reshape(program.shape[0], -1) - ref
    return float((d.pow(2).mean(dim=1).sqrt() / ref.pow(2).mean(dim=1).sqrt()).max())


def worst_pooled_rel(program, reference, window):
    """``worst_relative_rms`` of each image's latent averaged over windows of
    ``window`` x ``window`` latent pixels (NHWC [B, h, w, C] ->
    [B, h / window, w / window, C]; 1 keeps the full resolution)."""
    def pooled(t):
        t = t.float().permute(0, 3, 1, 2)
        w = min(window, t.shape[2])
        return (torch.nn.functional.avg_pool2d(t, w) if w > 1 else t).flatten(1)
    return worst_relative_rms(pooled(program), pooled(reference.to(program.device)))


def vae_image_rel(vsd, latents, images, fp8_control=False):
    """The VAE stage held by itself: the images against the reference's VAE
    decode of the same latents in fp32 (call it with TF32 off), the worst
    image's RMS difference over its RMS. With ``fp8_control`` the images
    judged are the reference's own decode of those latents with every
    convolution in float8 (the VAE's control: one precision below its
    configured bf16)."""
    latents = latents.to(vsd["decoder.conv_in.weight"].device)
    if fp8_control:
        images = ref_vae.latents_to_images(vsd, latents, torch.bfloat16, fp8_convs=True)
    return worst_relative_rms(images, ref_vae.latents_to_images(vsd, latents, torch.float32))
