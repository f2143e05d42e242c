"""SelftokPipeline: the end-user encode / decode API (counterpart of the
reference ``pipeline/pipeline.py``).

* ``encoding``: images -> SD3 VAE (bf16) -> latent format -> Qformer encoder
  -> VQ -> token ids.
* ``decoding``: ids -> codebook gather + post norm -> 50-step Euler sampler
  over the MMDiT (bucketed context lengths) -> SD3 VAE decode -> images.

Images and latents are NHWC. The pipeline runs on ``cuda`` unless the caller
passes ``device="cpu"``; with no GPU and no explicit ``device="cpu"`` it
raises. Weights are seeded random unless modules are handed in with
``set_weights`` (loading a reference ``.pth`` is not ported yet).

Precision tiers. ``encode_precision='highest'``: fp32 trunk, plain fp32
attention, exact-fp32 VQ kernel, and TF32 switched off for matmuls and for
cuDNN convolutions (cuDNN's default is on). ``'default'``: bf16 trunk, query
attention through the CUDA attention kernel. Decode runs in ``decode_dtype``
(bf16 or fp32) with the joint attention through the kernel in both.
"""

from __future__ import annotations

import numpy as np
import torch

from selftoktokenizer_tpu_torch.models import flow as flow_mod
from selftoktokenizer_tpu_torch.models import vq as vq_mod
from selftoktokenizer_tpu_torch.models.encoder import encoder_apply, encoder_margins
from selftoktokenizer_tpu_torch.models.mmdit import (
    mmdit_apply, mmdit_uncond_xonly, precompute_context_mods)
from selftoktokenizer_tpu_torch.models.tokenizer import (
    ImageTokenizer, TokenizerConfig, init_weights_, tokenizer_config_from_params)
from selftoktokenizer_tpu_torch.models.vae import (
    SD3LatentFormat, SDVAE, VAEConfig, vae_decode, vae_encode_mode)
from selftoktokenizer_tpu_torch.ops import routing
from selftoktokenizer_tpu_torch.ops.norms import layer_norm


def _resolve_device(device):
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "SelftokPipeline runs on a CUDA device; none is available. "
                "Pass device='cpu' explicitly to run on the CPU.")
        return torch.device("cuda")
    return torch.device(device)


class SelftokPipeline:
    """encoding(images) -> token ids; decoding(ids) -> images.

    cfg: the YAML config (AttrDict from core.config.load_config) in the
    reference's schema. zero_init_std: see
    ``models.tokenizer.init_weights_`` (0 keeps the reference init, whose
    zero adaLN gates switch every attention off).
    """

    def __init__(self, cfg, ckpt_path=None, vae_path=None, datasize=256,
                 steps=50, start=1.0, cfg_scale=1.0,
                 decode_dtype=torch.float32, seed=0, cond_vary=True,
                 encode_precision="highest", encode_only=False, device=None,
                 zero_init_std=0.0):
        if ckpt_path is not None or vae_path is not None:
            raise NotImplementedError(
                "checkpoint loading is not ported yet: ROADMAP.md queue item "
                "'.pth checkpoint input and a smoke.py counterpart'")
        if decode_dtype == "int8":
            raise NotImplementedError(
                "decode_dtype='int8' is not ported yet: ROADMAP.md queue item "
                "'int8 decode with q8_matmul'")
        if decode_dtype not in (torch.float32, torch.bfloat16):
            raise ValueError(f"decode_dtype must be torch.float32 or torch.bfloat16, got {decode_dtype}")
        _check_precision(encode_precision)
        self.device = _resolve_device(device)
        self.cfg = cfg
        self.datasize = datasize
        self.cfg_scale = cfg_scale
        self.decode_dtype = decode_dtype
        self.encode_precision = encode_precision

        self.tcfg: TokenizerConfig = tokenizer_config_from_params(
            dict(cfg.tokenizer.params))
        self.diti = self.tcfg.make_diti()
        self.K = self.tcfg.k
        if self.tcfg.decoder.renderer and not encode_only:
            raise NotImplementedError(
                "the renderer (renderer_apply, decoding_with_renderer) is not "
                "ported yet: ROADMAP.md queue item 'renderer'")

        # decode-time schedule + per-step token-count table
        self.steps = steps
        self.sched = flow_mod.make_schedule(steps, start, "uniform", shift=1.0)
        self.step_k = flow_mod.precompute_step_k(self.diti, self.sched,
                                                 t2k=self.tcfg.t2k)
        self.cond_vary = cond_vary
        self.parameterization = self.tcfg.diffusion.get(
            "parameterization", "velocity")

        gen = torch.Generator(device=self.device)
        gen.manual_seed(seed)
        with torch.device(self.device):
            tokenizer = ImageTokenizer(self.tcfg, encode_only=encode_only)
            vae = SDVAE(VAEConfig())
        init_weights_(tokenizer, gen, zero_init_std)
        init_weights_(vae, gen, zero_init_std)
        self.set_weights(tokenizer, vae)

    def set_weights(self, tokenizer: ImageTokenizer = None, vae: SDVAE = None):
        """Install modules (moved to the pipeline's device). The decoder's
        context adaLN table is computed here, in fp32, before the decoder is
        cast to the decode dtype in place: the pipeline keeps no fp32 copy
        of the 2B-parameter decoder."""
        if tokenizer is not None:
            tokenizer = tokenizer.to(self.device).requires_grad_(False)
            self.encoder = tokenizer.encoder
            self.model = tokenizer.model
            self._ctx_mods = None
            if self.model is not None:
                with torch.no_grad():
                    self._ctx_mods = precompute_context_mods(
                        self.model.float(), self.tcfg.decoder)
                self.model.to(self.decode_dtype)
        if vae is not None:
            self.vae = vae.to(self.device).requires_grad_(False)
            self.vae_cfg = vae.cfg

    # ------------------------------------------------------------------ API

    @torch.no_grad()
    def encoding(self, images, precision=None, kernels="cuda"):
        """images: NHWC float [-1,1] (numpy or tensor) -> token ids [B, K]
        int32. precision overrides the pipeline's encode_precision for this
        call. kernels="plain" swaps the CUDA kernels for their plain
        versions (for checking the kernels against them end to end)."""
        with routing.kernel_route(kernels):
            return self._encode_impl(self._to_device(images), precision)[1]

    @torch.no_grad()
    def encoding_margins(self, images, kernels="cuda"):
        """(token ids [B,K], VQ top-2 margins [B,K]) on the numerics of the
        encode path in use."""
        with routing.kernel_route(kernels):
            x0 = self._images_to_latents(self._to_device(images))
            serving = self.encode_precision == "default"
            with _fp32_exact(not serving):
                return encoder_margins(
                    self.encoder, self.tcfg.encoder, x0,
                    trunk_dtype=torch.bfloat16 if serving else None,
                    fast_attn=serving)

    @torch.no_grad()
    def decoding(self, ids, noise=None, generator=None, cfg_scale=None,
                 kernels="cuda", return_latents=False):
        """ids: [B,K] int -> reconstructed images NHWC float [0,1].

        noise: NHWC [B, datasize/8, datasize/8, 16] fp32 start noise, or
        drawn from ``generator`` (seed 0 when neither is given). cfg_scale:
        per-call classifier-free-guidance override (None = the pipeline's).
        return_latents: also return the sampler's final latents."""
        ids = self._to_device(ids)
        latent = self.datasize // 8
        if noise is None:
            if generator is None:
                generator = torch.Generator(device=self.device)
                generator.manual_seed(0)
            noise = torch.randn((ids.shape[0], latent, latent, 16),
                                generator=generator, device=self.device,
                                dtype=torch.float32)
        else:
            noise = self._to_device(noise).float()
        with routing.kernel_route(kernels):
            pred_x0 = self._decode_latents_impl(ids, noise, cfg_scale)
            images = self._latents_to_images(pred_x0)
        return (images, pred_x0) if return_latents else images

    def decoding_with_renderer(self, ids):
        raise NotImplementedError(
            "the renderer (renderer_apply, decoding_with_renderer) is not "
            "ported yet: ROADMAP.md queue item 'renderer'")

    @torch.no_grad()
    def decode_latents(self, latents):
        """VAE-decode latents (already in model space) to [0,1] images."""
        return self._latents_to_images(self._to_device(latents))

    # ---------------------------------------------------------------- impls

    def _to_device(self, a):
        if not torch.is_tensor(a):
            a = torch.from_numpy(np.array(a))   # a copy: jax arrays are read-only
        return a.to(self.device)

    def _images_to_latents(self, images):
        x0 = vae_encode_mode(self.vae, self.vae_cfg, images.to(torch.bfloat16))
        return SD3LatentFormat.process_in(x0).float()

    def _encode_impl(self, images, precision=None):
        prec = precision or self.encode_precision
        _check_precision(prec)
        x0 = self._images_to_latents(images)
        # 'default' is the bf16 serving path: bf16 trunk, kernel attention,
        # fast VQ scores. 'highest' keeps fp32 activations and plain fp32
        # attention, with TF32 off.
        serving = prec == "default"
        with _fp32_exact(not serving):
            return encoder_apply(
                self.encoder, self.tcfg.encoder, x0,
                trunk_dtype=torch.bfloat16 if serving else None,
                fast_attn=serving)

    def _tokens_to_context(self, ids):
        outs_q = vq_mod.get_output_from_indices(self.encoder.quantizer, ids)
        if self.tcfg.encoder.post_norm:
            ln = self.encoder.final_layer_norm3
            outs_q = layer_norm(outs_q, ln.weight, ln.bias)
        return outs_q

    def _decode_latents_impl(self, ids, noise, cfg_scale=None):
        if self.model is None:
            raise RuntimeError("this pipeline was built encode_only")
        cs = self.cfg_scale if cfg_scale is None else cfg_scale
        outs_q = self._tokens_to_context(ids)
        n_tok = outs_q.shape[1]
        super_mask = None
        if n_tok < self.K:
            # truncated token sequences: zero-pad the context to K and mask
            # the padding at every step
            outs_q = torch.nn.functional.pad(outs_q, (0, 0, 0, self.K - n_tok))
            super_mask = torch.arange(self.K, device=self.device)[None, :] < n_tok
        ehs = outs_q
        dd = self.decode_dtype
        dcfg = self.tcfg.decoder
        mods = None if self._ctx_mods is None else self._ctx_mods.to(dd)

        def model_fn(x, t, e, mask):
            v = mmdit_apply(self.model, dcfg, x.to(dd), t, e.to(dd), mask=mask,
                            context_see_xt=True, ctx_mods=mods)
            return v.float()

        uncond_fn = None
        if cs != 1.0:
            # the sampler's uncond branch is fully masked, so the context
            # stream is dead: run the x-only trunk
            def uncond_fn(x, t, e, mask):
                return mmdit_uncond_xonly(self.model, dcfg, x.to(dd), t).float()

        segments = self._decode_segments()
        if segments is None or cs != 1.0 or not self.cond_vary \
                or super_mask is not None:
            return flow_mod.p_sample_loop(
                model_fn, self.sched, noise, ehs,
                step_k=self.step_k if self.cond_vary else None, K=self.K,
                cfg_scale=cs, uncond_fn=uncond_fn, super_mask=super_mask,
                parameterization=self.parameterization)
        # Bucketed decode: tokens are diffusion-ordered and the per-step
        # active count is monotone decreasing, so later steps run with the
        # context sliced to the next 128-multiple: identical outputs (masked
        # tokens contribute nothing), fewer operations.
        img = noise
        for (s, e, Lc) in segments:
            sub = {k: v[s:e] for k, v in self.sched.items()}
            img = flow_mod.p_sample_loop(
                model_fn, sub, img, ehs[:, :Lc], step_k=self.step_k[s:e],
                K=Lc, parameterization=self.parameterization)
        return img

    def _decode_segments(self):
        """(start, end, ctx_len) segments grouping consecutive steps by the
        128-multiple context bucket covering their active tokens, or None
        for a single loop."""
        if self.K % 128 != 0:
            return None
        k = np.asarray(self.step_k)
        if np.any(np.diff(k) > 0):
            return None  # non-monotone schedule: keep the single loop
        bucket = np.minimum(((k + 1 + 127) // 128) * 128, self.K)
        segments = []
        s = 0
        for i in range(1, len(k) + 1):
            if i == len(k) or bucket[i] != bucket[s]:
                segments.append((s, i, int(bucket[s])))
                s = i
        if len(segments) <= 1:
            return None
        return segments

    def _latents_to_images(self, pred_x0):
        out = SD3LatentFormat.process_out(pred_x0).to(torch.bfloat16)
        recon = vae_decode(self.vae, self.vae_cfg, out)
        recon = torch.clamp(recon.float(), -1.0, 1.0)
        return (recon + 1.0) / 2.0


def _check_precision(prec):
    if prec == "high":
        raise NotImplementedError(
            "encode_precision='high' is not ported yet: ROADMAP.md queue item "
            "\"encode_precision='high'\"")
    if prec not in ("highest", "default"):
        raise ValueError(f"encode_precision must be 'highest' or 'default', got {prec!r}")


class _fp32_exact:
    """While active (enabled=True): TF32 off for CUDA matmuls and for cuDNN
    convolutions, so fp32 means fp32. The previous settings come back on
    exit."""

    def __init__(self, enabled=True):
        self.enabled = enabled

    def __enter__(self):
        if self.enabled:
            self._prev = (torch.backends.cuda.matmul.allow_tf32,
                          torch.backends.cudnn.allow_tf32)
            torch.backends.cuda.matmul.allow_tf32 = False
            torch.backends.cudnn.allow_tf32 = False
        return self

    def __exit__(self, *exc):
        if self.enabled:
            (torch.backends.cuda.matmul.allow_tf32,
             torch.backends.cudnn.allow_tf32) = self._prev
        return False
