"""SelftokPipeline: the end-user encode / decode API (counterpart of the
reference ``pipeline/pipeline.py``).

* ``encoding``: images -> SD3 VAE (bf16) -> latent format -> Qformer encoder
  -> VQ -> token ids.
* ``decoding``: ids -> codebook gather + post norm -> 50-step Euler sampler
  over the MMDiT (bucketed context lengths) -> SD3 VAE decode -> images.
* ``decoding_with_renderer``: ids -> codebook gather + post norm -> one pass
  of the mask-token renderer (``MMDiT_XL_Renderer``) -> SD3 VAE decode.

Images and latents are NHWC. The pipeline runs on ``cuda`` unless the caller
passes ``device="cpu"``; with no GPU and no explicit ``device="cpu"`` it
raises. Weights come from a reference ``.pth`` (``ckpt_path``, ``vae_path``;
``load_torch_checkpoint`` and the prefix handling of the reference loader),
from modules handed in with ``set_weights``, or are seeded random.

Precision tiers. ``encode_precision='highest'``: fp32 trunk, plain fp32
attention, exact-fp32 VQ kernel, and TF32 switched off for matmuls and for
cuDNN convolutions (cuDNN's default is on). ``'high'``: the same fp32 trunk
with TF32 switched on for its matmuls and convolutions, inside the call only
(Hopper has no 3-pass bf16 tier; TF32 is the nearest one). ``vq_argmax``
keeps its ids exact at every tier. ``'default'``: for the ``dual`` encoder a
bf16 trunk, its unmasked unidirectional query attention through the CUDA
attention kernel; the other encoder modes keep the fp32 trunk under the
global TF32 settings, as the reference does. Decode runs in
``decode_dtype`` (bf16 or fp32) with the joint attention through the kernel
in both; under CFG the unconditional branch drops the context stream
(``mmdit_uncond_xonly``), or, for a decoder with register tokens, runs it
with every context key masked (``mmdit_cfg_inference``).
``decode_dtype='int8'`` keeps bf16 activations and swaps the decoder's
projections for int8 weights (``ops.q8_matmul.quantize_model_``, after the
cast to bf16, as the reference quantizes), which run through the W8A8
``q8_matmul`` kernel.
"""

from __future__ import annotations

import numpy as np
import torch

from selftoktokenizer_tpu_torch.models import flow as flow_mod
from selftoktokenizer_tpu_torch.models import vq as vq_mod
from selftoktokenizer_tpu_torch.models.encoder import encoder_apply, encoder_margins
from selftoktokenizer_tpu_torch.models.mmdit import (
    load_uncond_buffers, mmdit_apply, mmdit_cfg_inference, mmdit_uncond_xonly,
    precompute_context_mods, renderer_apply)
from selftoktokenizer_tpu_torch.models.tokenizer import (
    ImageTokenizer, TokenizerConfig, init_weights_, tokenizer_config_from_params,
    tokenizer_from_state_dict)
from selftoktokenizer_tpu_torch.models.vae import (
    SD3LatentFormat, SDVAE, VAEConfig, vae_decode, vae_encode_mode, vae_from_state_dict)
from selftoktokenizer_tpu_torch.ops import routing
from selftoktokenizer_tpu_torch.ops.norms import layer_norm
from selftoktokenizer_tpu_torch.ops.precision import fp32_exact
from selftoktokenizer_tpu_torch.ops.q8_matmul import quantize_model_


def load_torch_checkpoint(path):
    """A reference .pth -> {name: tensor} on the CPU: the ``state_dict``
    entry when the file holds one, and only the entries that are tensors."""
    sd = torch.load(path, map_location="cpu", weights_only=False)
    if isinstance(sd, dict) and "state_dict" in sd:
        sd = sd["state_dict"]
    return {k: v for k, v in sd.items() if torch.is_tensor(v)}


def _strip_prefix(sd, prefix):
    n = len(prefix)
    return {k[n:]: v for k, v in sd.items() if k.startswith(prefix)}


def _resolve_device(device):
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "SelftokPipeline runs on a CUDA device; none is available. "
                "Pass device='cpu' explicitly to run on the CPU.")
        return torch.device("cuda")
    return torch.device(device)


class SelftokPipeline:
    """encoding(images) -> token ids; decoding(ids) -> images (a decoder
    config); decoding_with_renderer(ids) -> images (a renderer config).

    cfg: the YAML config (AttrDict from core.config.load_config) in the
    reference's schema. ckpt_path: a reference tokenizer .pth (``encoder.*``
    and ``model.*``, under an optional ``state_dict`` entry and ``module.``
    prefixes; with ``ema_decoder`` the ``ema_state_dict.*`` copy is read);
    ``encode_only`` reads the encoder alone. The quantizer's EMA buffers,
    when the file has them, become ``self.vq_state``. vae_path: an SD3 VAE
    .pt (optional ``first_stage_model.`` prefix). decode_dtype:
    torch.float32, torch.bfloat16 or 'int8' (bf16 activations, int8 decoder
    projections). zero_init_std: see
    ``models.tokenizer.init_weights_`` (0 keeps the reference init, whose
    zero adaLN gates switch every attention off).
    """

    def __init__(self, cfg, ckpt_path=None, vae_path=None, datasize=256,
                 steps=50, start=1.0, cfg_scale=1.0, ema_decoder=False,
                 decode_dtype=torch.float32, seed=0, cond_vary=True,
                 encode_precision="highest", encode_only=False, device=None,
                 zero_init_std=0.0):
        self.int8_decode = decode_dtype == "int8"
        if self.int8_decode:
            decode_dtype = torch.bfloat16
        if decode_dtype not in (torch.float32, torch.bfloat16):
            raise ValueError("decode_dtype must be torch.float32, torch.bfloat16 or "
                             f"'int8', got {decode_dtype}")
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
        self.vq_state = None
        if ckpt_path is not None:
            sd = load_torch_checkpoint(ckpt_path)
            if ema_decoder and any(k.startswith("ema_state_dict") for k in sd):
                sd = _strip_prefix(sd, "ema_state_dict.")
            tokenizer, self.vq_state = tokenizer_from_state_dict(
                sd, self.tcfg, encode_only=encode_only)
        else:
            with torch.device(self.device):
                tokenizer = ImageTokenizer(self.tcfg, encode_only=encode_only)
            init_weights_(tokenizer, gen, zero_init_std)
        if vae_path is not None:
            vsd = load_torch_checkpoint(vae_path)
            if any(k.startswith("first_stage_model.") for k in vsd):
                vsd = _strip_prefix(vsd, "first_stage_model.")
            vae = vae_from_state_dict(vsd)
        else:
            with torch.device(self.device):
                vae = SDVAE(VAEConfig())
            init_weights_(vae, gen, zero_init_std)
        self.set_weights(tokenizer, vae)

    def set_weights(self, tokenizer: ImageTokenizer = None, vae: SDVAE = None):
        """Install modules (moved to the pipeline's device). The decoder's
        context adaLN table is computed here, in fp32, before the decoder is
        cast to the decode dtype in place: the pipeline keeps no fp32 copy
        of the 2B-parameter decoder. The unconditional buffers the decoder
        config names (``uncond_y_file`` / ``uncond_c_file``) are set on it
        before the cast. Under int8 the bf16 decoder's eligible linears are
        then quantized in place."""
        if tokenizer is not None:
            tokenizer = tokenizer.to(self.device).requires_grad_(False)
            self.encoder = tokenizer.encoder
            self.model = tokenizer.model
            self._ctx_mods = None
            if self.model is not None:
                self.model.set_uncond_buffers(load_uncond_buffers(self.tcfg.decoder))
                with torch.no_grad():
                    self._ctx_mods = precompute_context_mods(
                        self.model.float(), self.tcfg.decoder)
                self.model.to(self.decode_dtype)
                if self.int8_decode:
                    quantize_model_(self.model)
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
            return encode_latents(self.encoder, self.tcfg.encoder, x0, self.encode_precision,
                                  margins=True)

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

    @torch.no_grad()
    def decoding_with_renderer(self, ids, kernels="cuda", return_latents=False):
        """ids: [B,K] int -> images NHWC float [0,1] from one pass of the
        mask-token renderer. The codebook context enters the decoder in fp32
        and is cast after its embedding, as in the reference.
        kernels="plain" swaps the CUDA kernels for their plain versions;
        return_latents: also return the renderer's latents."""
        self._require_decoder(renderer=True)
        ids = self._to_device(ids)
        with routing.kernel_route(kernels):
            pred_x0 = renderer_apply(self.model, self.tcfg.decoder,
                                     self._tokens_to_context(ids),
                                     ctx_mods=self._ctx_mods)
            images = self._latents_to_images(pred_x0)
        return (images, pred_x0) if return_latents else images

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
        return encode_latents(self.encoder, self.tcfg.encoder, self._images_to_latents(images),
                              prec)

    def _tokens_to_context(self, ids):
        outs_q = vq_mod.get_output_from_indices(self.encoder.quantizer, ids)
        if self.tcfg.encoder.post_norm:
            ln = self.encoder.final_layer_norm3
            outs_q = layer_norm(outs_q, ln.weight, ln.bias)
        return outs_q

    def _require_decoder(self, renderer):
        if self.model is None:
            raise RuntimeError("this pipeline was built encode_only: it has no decoder")
        if self.tcfg.decoder.renderer != renderer:
            raise ValueError(
                f"{self.tcfg.model_name} "
                + ("is no renderer: use decoding" if renderer
                   else "is a renderer: use decoding_with_renderer"))

    def _decode_latents_impl(self, ids, noise, cfg_scale=None):
        self._require_decoder(renderer=False)
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
        if cs != 1.0 and dcfg.register_length == 0:
            # the sampler's uncond branch is fully masked, so the context
            # stream is dead: run the x-only trunk
            def uncond_fn(x, t, e, mask):
                return mmdit_uncond_xonly(self.model, dcfg, x.to(dd), t).float()
        elif cs != 1.0:
            # register keys stay active: the full unconditional pass
            def uncond_fn(x, t, e, mask):
                return mmdit_cfg_inference(self.model, dcfg, x.to(dd), t, None,
                                           mask=torch.zeros_like(mask),
                                           ctx_mods=mods).float()

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


# the TF32 setting of each encode tier: off, on, untouched (the bf16 trunk)
_EXACT = {"highest": True, "high": False, "default": None}


def _serving(prec, enc_cfg):
    return prec == "default" and enc_cfg.qformer_mode == "dual"


def encode_latents(encoder, enc_cfg, x0, precision="highest", margins=False):
    """The encode of one precision tier from the tokenizer's latents:
    (quantized context, ids), or with ``margins`` (ids, VQ top-2 margins).
    'default' is the bf16 serving path of the dual encoder (bf16 trunk,
    kernel attention); 'highest' keeps fp32 activations and plain fp32
    attention with TF32 off; 'high' the same with TF32 on, inside the call.
    The other encoder modes take no bf16 trunk at 'default'. Without
    ``margins`` the ids come from ``vq_argmax`` on a CUDA device, exact at
    every tier; with them, from the exact fp32 scores of the same trunk."""
    _check_precision(precision)
    serving = _serving(precision, enc_cfg)
    fn = encoder_margins if margins else encoder_apply
    with fp32_exact(_EXACT[precision]):
        return fn(encoder, enc_cfg, x0, trunk_dtype=torch.bfloat16 if serving else None,
                  fast_attn=serving)


def _check_precision(prec):
    if prec not in _EXACT:
        raise ValueError(
            f"encode_precision must be 'highest', 'high' or 'default', got {prec!r}")
