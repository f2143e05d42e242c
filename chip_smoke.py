"""Chip smoke test of the PyTorch / CUDA port: builds the CUDA kernels,
holds each against its plain PyTorch version on the GPU, and drives, at full
width on seeded random weights, the flagship encode (at 'highest', 'high'
and 'default') + 50-step bf16 decode,
the int8 decode (``decode_dtype='int8'``, through ``q8_matmul``), the
one-step renderer in bf16 and int8, and training: three tokenizer train
steps and two renderer train steps at batch 4, fp32 with TF32 off, the
first of each held against the same step with the plain versions forced;
the accumulated tokenizer step (``train_step_accum``) held against
``train_step`` at batch 4 and timed at a global batch of 16 that no single
step holds; the data-parallel step (``dp_train_step``) in a one-rank NCCL
group, held against ``train_step``; and the SD3 VAE's trainer at its own
widths (256 px, batch 8, bf16). Before training, phase "zoo" drives the rest
of the model zoo at full width: seven named encoders at batch 8 (each
interaction mode, K = 24 and K = 1024), the variant decoder (qk-norm 'ln',
'pos_t_emb', mean pooling; bf16 and int8) with one sampler step of the
batched CFG trunk, a decoder with register tokens at cfg 2.0 and
RenderDiT_XL, each against the forced plain versions. Phase "families" then
drives the sixth slice's models at full width in fp32: the multi-resolution
encoder (its vq_argmax ids against the plain run), the multi-resolution
MMDiT (bf16 against fp32), the multi-resolution tokenizer's loss and
gradients (against the plain run), DiT-XL/2 with the DDPM loss and samplers,
and the SD3 text encoders. Phase "corpus" then reads image files and
scores reconstructions through the port's tools at the flagship widths: it
writes 64 images of mixed sizes and modes (RGB, grayscale, RGBA and palette
PNG from the standard library's writer, JPEG when PIL is installed) and two
tar shards of them; runs ``tools/tokenize_corpus.py``'s ``main`` over the
folder and the shards at batch 32, 'highest' and 'default' and once with
``--margin-stats``, from an encoder ``.pth`` and a VAE ``.pt`` of the
seeded weights, and holds each row's ids (and margins) equal to the
pipeline's own encode of the same batches of the same pixels; times the
tool, the encode alone, the loader alone and the device's busy share of the
tool's loop; runs ``tools/eval_recon.py``'s loop with the 'random'
Inception and LPIPS nets over 16 images through the bf16 renderer and 4
through the 50-step bf16 decode (PSNR and SSIM equal to ``utils.metrics``
on the same reconstructions, LPIPS(x, x) = 0, Inception features and LPIPS
on the card within 1e-3 of their scale of the CPU's, the global TF32 flags
unchanged) and times Inception (batch 32) and LPIPS (batch 8); and runs
``tools/smoke.py`` on one image (a 256 x 256 PNG). It prints ``loader:``
with the reason, decided from what is installed before anything runs:
``native`` where a C++ compiler finds ``jpeglib.h`` and ``png.h`` (a failed
build of the C++ loader fails the phase), ``pil`` where it does not and PIL
is installed, ``arrays`` where neither is (the tools' loops are fed 256 x
256 arrays made in memory, and the smoke tool, which reads and writes files,
does not run). Phase "drivers" then runs the training drivers through
their ``main`` in a temporary directory, at the flagship widths: 40
``gen_corpus`` textures at 256 px; ``train_vae`` (the SD3 VAE at its
widths, 5 steps at batch 8 in bf16, a held-out split) and
``encode_corpus`` with its checkpoint; ``train_tokenizer`` at full depth
(batch 4, fp32 with TF32 off, an EMA copy, 4 steps, 8-step eval decodes
of the held-out rows at steps 0, 2 and 4 with the image-space eval),
its metrics read back through the port's
``tools/summarize_convergence.py``; the file round trip with MMDiT_XL cut
to depth 2 at width 1536 (4 steps straight against 2 + a checkpoint + a
resume, the final loss within 1e-4 relative; ``convert_ckpt export`` and
``export --ema``; ``SelftokPipeline`` from the export, every leaf
bit-equal to the state's and the encode's ids equal to the state's
encoder's under the 1e-6 margin rule; ``certify_tiers``;
``train_renderer`` from the export; ``demo_e2e`` over the three
checkpoints); ``train_renderer`` at full depth (3 steps at batch 4, fp32).
It prints each driver's wall, peak memory, warm steps/s and the device's
busy share of its step loop. Phase "tools" (last) runs the measurement
tools (``selftoktokenizer_tpu_torch/tools/measure_k1024.py`` and the nine
``bench_*.py``) in process at short settings, each JSON line held to its
documented keys, and holds the paths they drive: the flagship at 512 px
(encode at batch 8, 'highest' and 'default', under the top-2 margin rules;
the 50-step bf16 decode at batch 2 within 5e-2 of the plain route), the
K=1024 encode at batch 32, 'highest' (one ``vq_argmax`` launch over 32,768
rows, ids under the 1e-6 rule), the rematerialised train step at depth 24 x
1536, batch 8, against the same step without remat (the train tolerances;
48 forward and 24 backward attention launches), the three render loops'
images equal, ``bench_scaling`` over a one-rank NCCL group and
``bench_int8``'s 191 ``q8_matmul`` launches a cond call. Each path runs
with every launch count set to 0 just before it and read just after.

Run with no arguments on a machine with one NVIDIA GPU (sm_90a) and the
CUDA toolkit:

    python3 chip_smoke.py

It exits non-zero when no GPU is available or when any phase fails. The
last line of its standard output is one JSON object
``{"ok": true, "device": {...}}``; the line before the card line is one
JSON object ``{"kernels": [...]}`` with each kernel's error, times and bound.
``--only kernels`` stops after the kernel phase, ``--only train``,
``--only zoo``, ``--only families``, ``--only corpus``, ``--only
drivers``, ``--only sharded`` and ``--only tools`` run that phase alone
(no kernel line, no final line); ``--ptxas`` prints the compiler's
register and shared-memory report; ``--profile`` adds a
torch.profiler pass over one warm bf16 decode, one warm int8 decode, one
extra tokenizer and renderer train step and the zoo's two forms of a CFG
sampler step;
``--q8-sweep`` times every ``q8_matmul`` plan at the main path's shapes.
"""

from __future__ import annotations

import argparse
import gc
import json
import math
import statistics
import subprocess
import sys
import time

import torch

from selftoktokenizer_tpu_torch.utils import peaks

# published peaks of one H100 SXM (dense): the roofline the bounds are stated against
PEAK_BF16_FLOPS = peaks.BF16_FLOPS
PEAK_FP32_FLOPS = peaks.FP32_FLOPS
PEAK_TF32_FLOPS = peaks.TF32_FLOPS
PEAK_INT8_OPS = peaks.INT8_OPS
PEAK_BYTES = peaks.BYTES

ATTN_TOL = {torch.bfloat16: 2e-2, torch.float32: 2e-5}
# q8_matmul equals its plain version bit for bit, except fp32 with a bias:
# there the plain version takes the kernel's fused multiply-add in float64,
# which rounds twice when the float64 sum lands on an fp32 tie, so one fp32
# ulp is allowed (relative 2^-23)
Q8_FP32_BIAS_RTOL = 2.0 ** -23
# conv3ch_3x3: fp32 sums of 27 products in another order (1e-5, the TPU
# kernel's own test); bf16 output may round to the neighbouring value (one
# bf16 ulp, relative 2^-7)
CONV_TOL = {torch.float32: (1e-5, 1e-5), torch.bfloat16: (2.0 ** -7, 1e-6)}
VQ_MARGIN = 1e-6          # ids may differ from the plain version only below this top-2 margin
DEFAULT_TIER_MARGIN = 0.05  # bf16 trunk: kernel and plain ids may differ only below this margin
# 'high' (TF32 trunk): the plain argmax scores in TF32 too (errors up to about
# 2e-3 on unit vectors), the kernel exactly; margins read at 'highest'
HIGH_TIER_MARGIN = 1e-2
LATENT_TOL = 5e-2         # bf16 decode, kernels against forced plain versions
# int8 renderer, kernels against forced plain versions, relative to the latent
# scale: the attention kernel and plain attention round bf16 at other places,
# and the per-row activation quantizer of the next int8 linear turns some of
# those ulps into a step of one level (max|x| / 127), in one pass that no
# sampler averages. The rule tests/test_torch_renderer.py holds the int8
# renderer to against JAX: all but one value in a thousand within 3e-2 of the
# scale, none beyond 6e-2.
RENDER_INT8_TOL = (3e-2, 6e-2)
# the attention backward (plain PyTorch in an autograd Function) against
# autograd through the plain forward, relative to each grad's largest value
ATTN_GRAD_TOL = {torch.bfloat16: 2e-2, torch.float32: 1e-4}
# a train step on the kernels against the same step on the plain versions
# (fp32, TF32 off): the loss, and each gradient leaf (its largest error
# against its largest value, and its cosine with the plain gradient); the
# accumulated and the data-parallel steps are held against train_step by
# the same rule
TRAIN_LOSS_RTOL = 1e-4
TRAIN_GRAD_TOL = 1e-3
TRAIN_GRAD_COS = 0.9999
# the accumulated / data-parallel step's VQ buffers against train_step's:
# largest error within this fraction of the buffer's largest value
TRAIN_VQ_TOL = 1e-5


def log(msg):
    print(msg, flush=True)


def card_line():
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60)
    if out.returncode != 0:
        raise RuntimeError(f"nvidia-smi failed: {out.stderr}")
    return out.stdout.strip().splitlines()[0].strip()


_SM_CLOCK_HZ = []


def sm_clock_hz():
    """The card's maximum SM clock, as nvidia-smi reports it (read once)."""
    if not _SM_CLOCK_HZ:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=clocks.max.sm", "--format=csv,noheader,nounits"],
            capture_output=True, text=True, timeout=60)
        if out.returncode != 0:
            raise RuntimeError(f"nvidia-smi failed: {out.stderr}")
        _SM_CLOCK_HZ.append(float(out.stdout.strip().splitlines()[0]) * 1e6)
    return _SM_CLOCK_HZ[0]


HOLD_CYCLES = 40_000_000   # about 20 ms of device spin at the H100's clock


def time_ms(fn, warmup=3, reps=10, rounds=5, hold=True):
    """Median over rounds of (CUDA-event time of `reps` calls) / reps.

    These calls take tens of microseconds on the device, less than the host
    needs to enqueue one, so each round first parks the stream on a spin
    kernel: the host enqueues all `reps` calls behind it and the events then
    bracket device time only, not the host's launch rate. hold=False leaves
    the spin out and gives the time per call as Python can issue them."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(rounds):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        if hold:
            torch.cuda._sleep(HOLD_CYCLES)
        start.record()
        for _ in range(reps):
            fn()
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end) / reps)
    times.sort()
    return times[len(times) // 2]


# --------------------------------------------------------------- kernels ---

def active_keys(mask, B, Lk):
    """The keys the function needs, summed over the batch rows: a row's
    active keys, or all Lk for a row with none (its output is the mean of
    every value)."""
    if mask is None:
        return B * Lk
    n = mask.sum(dim=1)
    return int(torch.where(n > 0, n, Lk).sum())


def attn_bound(B, H, Lq, Lk, D, dtype, mask):
    """Both products over each row's active keys only, against reading q
    and the active keys' k and v, writing the output, and reading the mask
    once: see _bound."""
    nk = active_keys(mask, B, Lk)
    flops = 4.0 * H * Lq * D * nk
    item = 2 if dtype == torch.bfloat16 else 4
    nbytes = (2 * B * Lq + 2 * nk) * D * H * item + (0 if mask is None else B * Lk)
    return _bound(flops, nbytes, dtype)


def _bound(flops, nbytes, dtype):
    """(ms, by, fp32 CUDA-core ms or None) of `flops` products of the type
    and `nbytes` moved. The operations at the card's fastest peak for the
    type: bf16 on the tensor cores; fp32 on the tensor cores in split TF32
    (three TF32 passes a product at 495 TFLOP/s, as fp32-accurate as the
    card's tensor cores go, and the kernels' own route). For fp32 the third
    value is the same work on the CUDA cores at 67 TFLOP/s."""
    t_bytes = nbytes / PEAK_BYTES
    if dtype == torch.bfloat16:
        t_ops, cuda_core = flops / PEAK_BF16_FLOPS, None
    else:
        t_ops = 3 * flops / PEAK_TF32_FLOPS
        cuda_core = max(flops / PEAK_FP32_FLOPS, t_bytes) * 1e3
    return max(t_ops, t_bytes) * 1e3, "operations" if t_ops >= t_bytes else "bytes", cuda_core


def attn_backward_bound(B, H, Lq, Lk, D, dtype, mask):
    """The backward's five products (the scores again, dV, dP, dQ, dK) over
    each row's active keys, against reading q, dO and the active keys' k, v,
    and writing dq, dk, dv once (dk and dv for every key: a masked key's are
    zeros): see _bound."""
    nk = active_keys(mask, B, Lk)
    item = 2 if dtype == torch.bfloat16 else 4
    flops = 10.0 * H * Lq * D * nk
    nbytes = (3 * B * Lq + 2 * nk + 2 * B * Lk) * D * H * item
    return _bound(flops, nbytes, dtype)


def attn_exp_bound(B, H, Lq, Lk, mask):
    """The exponentials alone: one per score of an active key on the
    special-function units, 16 a clock on each of the 132 SMs."""
    return H * Lq * active_keys(mask, B, Lk) / (132 * 16 * sm_clock_hz()) * 1e3


def vq_bound(N, C, D=16):
    """The least time for the screen-and-rescore kernel: the larger of its
    TF32 products (2*N*C*D at the TF32 peak), one CUDA-core compare per
    score (N*C over 132 SMs x 128 lanes a clock) and its bytes. Also
    returns the fp32 CUDA-core figure of scoring every code exactly."""
    t_tf32 = 2.0 * N * C * D / PEAK_TF32_FLOPS
    t_cmp = N * C / (132 * 128 * sm_clock_hz())
    t_bytes = (N * D * 4 + C * D * 4 + N * 4) / PEAK_BYTES
    fp32_ms = max(2.0 * N * C * D / PEAK_FP32_FLOPS, t_bytes) * 1e3
    t = max(t_tf32, t_cmp, t_bytes)
    return t * 1e3, "operations" if t > t_bytes else "bytes", fp32_ms


def max_abs_score(q, k):
    """The largest |q . k| / sqrt(D) of a case."""
    qf, kf = q.detach().float(), k.detach().float()
    return float((qf @ kf.transpose(-1, -2)).abs().max()) / math.sqrt(q.shape[-1])


def attn_case(fa, name, B, H, Lq, Lk, D, dtype, mask_kind, gen, timed, layout="dense",
              qk_std=1.0):
    """layout "qkv": q, k and v are the strided views the models' qkv split
    makes of one [B, L, 3, H, D] tensor (row stride 3*H*D, head stride D).
    qk_std: the std of q and k (dense layout; 2.5 gives scores whose
    largest reaches about 30, where fp32 rounding shows most)."""
    import torch.nn.functional as F

    dev = "cuda"
    if layout == "qkv":
        if Lq != Lk:
            raise RuntimeError(f"{name}: a qkv split has one length")
        qkv = torch.randn((B, Lq, 3, H, D), generator=gen, device=dev, dtype=torch.float32).to(dtype)
        q, k, v = (qkv[:, :, i].permute(0, 2, 1, 3) for i in range(3))
        if q.stride() != (Lq * 3 * H * D, D, 3 * H * D, 1):
            raise RuntimeError(f"{name}: not the qkv split's strides")
    else:
        q = (torch.randn((B, H, Lq, D), generator=gen, device=dev) * qk_std).to(dtype)
        k = (torch.randn((B, H, Lk, D), generator=gen, device=dev) * qk_std).to(dtype)
        v = torch.randn((B, H, Lk, D), generator=gen, device=dev, dtype=torch.float32).to(dtype)
    mask = None
    pos = torch.arange(Lk, device=dev)[None, :]
    if mask_kind and mask_kind.startswith("prefix"):
        # the decode path's masks: a prefix of the context keys active, all x
        # keys active (256 x keys at 256 px, or the count the kind names)
        n_x = int(mask_kind[6:] or 256)
        n_ctx = Lk - n_x if Lk > n_x else Lk // 2
        active = torch.randint(1, n_ctx + 1, (B,), generator=gen, device=dev)
        mask = (pos < active[:, None]) | (pos >= n_ctx)
    elif mask_kind == "uncond_registers":
        # the register decoder's uncond call: registers and x keys active
        mask = ((pos < 4) | (pos >= Lk - 256)).expand(B, Lk).contiguous()
    elif mask_kind == "cfg_batched":
        # rows [0, B/2) a decode prefix, rows [B/2, B) the x keys only
        active = torch.randint(1, Lk - 256 + 1, (B,), generator=gen, device=dev)
        active[B // 2:] = 0
        mask = (pos < active[:, None]) | (pos >= Lk - 256)
    elif mask_kind == "renderdit":
        # RenderDiT's: a prefix of the 512 token keys active, and on odd rows
        # the last 56 of the 256 mask-token keys masked
        active = torch.randint(1, Lk - 256 + 1, (B,), generator=gen, device=dev)
        mask = (pos < active[:, None]) | (pos >= Lk - 256)
        mask[1::2, Lk - 56:] = False
    elif mask_kind == "random":
        mask = torch.rand((B, Lk), generator=gen, device=dev) > 0.5
        mask[:, 0] = True
    elif mask_kind == "ones":
        # the renderer's masks: its pipeline masks no token
        mask = torch.ones((B, Lk), dtype=torch.bool, device=dev)
    elif mask_kind == "full_row":
        mask = torch.rand((B, Lk), generator=gen, device=dev) > 0.5
        mask[0, :] = False            # batch 0: every key masked -> uniform mean
    elif mask_kind == "tiles":
        # whole 64-key tiles masked (the split-TF32 kernels leave them out
        # where the row has an active key), and batch 0 with every key masked
        mask = torch.ones((B, Lk), dtype=torch.bool, device=dev)
        mask[:, 64:192] = False
        mask[0, :] = False
    before = fa.launch_count
    out = fa.flash_sdpa_key_mask(q, k, v, mask)
    torch.cuda.synchronize()
    if fa.launch_count != before + 1:
        raise RuntimeError(f"{name}: the wrapper did not count its launch")
    ref = fa.flash_sdpa_key_mask_plain(q, k, v, mask)
    if out.shape != ref.shape or out.dtype != ref.dtype:
        raise RuntimeError(f"{name}: shape or type differs from the plain version")
    if not torch.isfinite(out.float()).all():
        raise RuntimeError(f"{name}: non-finite output")
    err = (out.float() - ref.float()).abs().max().item()
    tol = ATTN_TOL[dtype]
    if mask_kind in ("full_row", "tiles"):
        uni = v[0].float().mean(dim=1, keepdim=True).expand(-1, Lq, -1)
        uerr = (out[0].float() - uni).abs().max().item()
        if uerr > tol:
            raise RuntimeError(f"{name}: fully masked row is not the uniform mean ({uerr})")
    if err > tol:
        raise RuntimeError(f"{name}: kernel differs from the plain version by {err} > {tol}")
    # the output is [B, Lq, H, D] memory: merging the heads is a view
    if out.permute(0, 2, 1, 3).stride() != (Lq * H * D, H * D, D, 1):
        raise RuntimeError(f"{name}: the output is not laid out [B, Lq, H, D]")
    rec = {"case": name, "shape": [B, H, Lq, Lk, D], "dtype": str(dtype).replace("torch.", ""),
           "mask": mask_kind, "layout": layout, "max_abs_err": err, "tol": tol}
    if qk_std != 1.0:
        # how far each of the two is from the float64 function: at such
        # scores fp32's own rounding is most of their difference
        sd = torch.matmul(q.double(), k.double().transpose(-1, -2)) / math.sqrt(D)
        exact = torch.matmul(torch.softmax(sd, dim=-1), v.double())
        rec.update(max_abs_score=max_abs_score(q, k),
                   float64_err=(out.double() - exact).abs().max().item(),
                   plain_float64_err=(ref.double() - exact).abs().max().item())
    if dtype == torch.bfloat16:
        rec["launch"] = {"stages": fa.STAGES[D], "grid": [-(-Lq // fa.BM), B * H],
                         "smem": fa.smem_bytes(D)}
    else:
        rec["launch"] = {"stages": fa.TF32_STAGES, "grid": [-(-Lq // 64), B * H],
                         "smem": fa.tf32_smem_bytes("forward", D, dtype)}
    if timed:
        bound, by, cuda_core = attn_bound(B, H, Lq, Lk, D, dtype, mask)
        am = None if mask is None else mask[:, None, None, :]
        rec.update(
            ms=time_ms(lambda: fa.flash_sdpa_key_mask(q, k, v, mask)),
            host_paced_ms=time_ms(lambda: fa.flash_sdpa_key_mask(q, k, v, mask), hold=False),
            plain_ms=time_ms(lambda: fa.flash_sdpa_key_mask_plain(q, k, v, mask), reps=3, rounds=3),
            library_ms=time_ms(lambda: F.scaled_dot_product_attention(q, k, v, attn_mask=am)),
            bound_ms=bound, bound_by=by, exp_bound_ms=attn_exp_bound(B, H, Lq, Lk, mask))
        rec["share"] = bound / rec["ms"]
        if cuda_core is not None:
            rec.update(fp32_cuda_core_bound_ms=cuda_core, fp32_cuda_core_share=cuda_core / rec["ms"])
    log(f"  attention {name}: {json.dumps(rec)}")
    return rec


def attn_grad_case(fa, name, B, H, Lq, Lk, D, dtype, mask_kind, layout, timed, gen, qk_std=1.0):
    """The wrapper's gradients (kernel forward with row statistics, the
    backward kernel) against autograd through the plain forward, on the
    same inputs; two backward launches on the same inputs bit-equal.
    qk_std: as for attn_case."""
    dev = "cuda"
    if layout == "qkv":
        leaf = torch.randn((B, Lq, 3, H, D), generator=gen, device=dev).to(dtype).requires_grad_()
        q, k, v = (leaf[:, :, i].permute(0, 2, 1, 3) for i in range(3))
    else:
        q, k, v = ((torch.randn((B, H, L, D), generator=gen, device=dev) * std)
                   .to(dtype).requires_grad_() for L, std in ((Lq, qk_std), (Lk, qk_std), (Lk, 1.0)))
    mask = None
    pos = torch.arange(Lk, device=dev)[None, :]
    if mask_kind == "prefix":
        n_ctx = Lk - 256 if Lk > 256 else Lk // 2
        active = torch.randint(1, n_ctx + 1, (B,), generator=gen, device=dev)
        mask = (pos < active[:, None]) | (pos >= n_ctx)
    elif mask_kind == "ones":
        mask = torch.ones((B, Lk), dtype=torch.bool, device=dev)
    elif mask_kind in ("random", "full_row"):
        mask = torch.rand((B, Lk), generator=gen, device=dev) > 0.5
        mask[:, 0] = True
        if mask_kind == "full_row":
            mask[0, :] = False
    elif mask_kind == "tiles":
        mask = torch.ones((B, Lk), dtype=torch.bool, device=dev)
        mask[:, 64:192] = False
        mask[0, :] = False
    do = torch.randn((B, H, Lq, D), generator=gen, device=dev).to(dtype)
    before = (fa.launch_count, fa.backward_launch_count)
    out = fa.flash_sdpa_key_mask(q, k, v, mask)
    grads = torch.autograd.grad(out, (q, k, v), do)
    torch.cuda.synchronize()
    if (fa.launch_count, fa.backward_launch_count) != (before[0] + 1, before[1] + 1):
        raise RuntimeError(f"{name}: the forward and the backward did not launch once each")
    ref = torch.autograd.grad(fa.flash_sdpa_key_mask_plain(q, k, v, mask), (q, k, v), do)
    rec = {"case": name, "shape": [B, H, Lq, Lk, D], "dtype": str(dtype).replace("torch.", ""),
           "mask": mask_kind, "layout": layout, "tol": ATTN_GRAD_TOL[dtype],
           "launch": {"grid_dq": [-(-Lq // 64), B * H], "grid_dkdv": [-(-Lk // 64), B * H],
                      "smem_dq": fa.tf32_smem_bytes("dq", D, dtype),
                      "smem_dkdv": fa.tf32_smem_bytes("dkdv", D, dtype)}}
    if qk_std != 1.0:
        rec["max_abs_score"] = max_abs_score(q, k)
    err_abs = 0.0
    for n, g, r in zip("qkv", grads, ref):
        if g.dtype != dtype or not torch.isfinite(g.float()).all():
            raise RuntimeError(f"{name}: d{n} is not finite {dtype}")
        diff = (g.float() - r.float()).abs().max().item()
        err_abs = max(err_abs, diff)
        err = diff / max(r.float().abs().max().item(), 1e-30)
        rec[f"d{n}_rel_err"] = err
        if err > ATTN_GRAD_TOL[dtype]:
            raise RuntimeError(f"{name}: d{n} differs from the plain autograd by {err} of its scale")
    rec["max_abs_err"] = err_abs
    # the backward kernel on its own inputs, twice: the same bits (no atomics)
    q0, k0, v0 = q.detach(), k.detach(), v.detach()
    o, stats = fa._launch(q0, k0, v0, mask, stats=True)
    g1 = fa.flash_sdpa_key_mask_backward(q0, k0, v0, mask, o, do, stats)
    g2 = fa.flash_sdpa_key_mask_backward(q0, k0, v0, mask, o, do, stats)
    if not all(torch.equal(x, y) for x, y in zip(g1, g2)):
        raise RuntimeError(f"{name}: two backward launches on the same inputs differ")
    if timed:
        import torch.nn.functional as F

        qr, kr, vr = (t.detach().requires_grad_() for t in (q0, k0, v0))
        out_p = fa.flash_sdpa_key_mask_plain(qr, kr, vr, mask)
        ql, kl, vl = (t.detach().requires_grad_() for t in (q0, k0, v0))
        out_l = F.scaled_dot_product_attention(
            ql, kl, vl, attn_mask=None if mask is None else mask[:, None, None, :])
        bound, by, cuda_core = attn_backward_bound(B, H, Lq, Lk, D, dtype, mask)
        rec.update(
            ms=time_ms(lambda: fa.flash_sdpa_key_mask_backward(q0, k0, v0, mask, o, do, stats)),
            plain_ms=time_ms(lambda: fa.flash_sdpa_key_mask_backward_plain(
                q0, k0, v0, mask, o, do, stats), reps=3, rounds=3),
            plain_autograd_ms=time_ms(
                lambda: torch.autograd.grad(out_p, (qr, kr, vr), do, retain_graph=True),
                reps=3, rounds=3),
            library_ms=time_ms(
                lambda: torch.autograd.grad(out_l, (ql, kl, vl), do, retain_graph=True),
                reps=3, rounds=3),
            forward_with_stats_ms=time_ms(lambda: fa._launch(q0, k0, v0, mask, stats=True)),
            bound_ms=bound, bound_by=by)
        rec["share"] = bound / rec["ms"]
        if cuda_core is not None:
            rec.update(fp32_cuda_core_bound_ms=cuda_core, fp32_cuda_core_share=cuda_core / rec["ms"])
    log(f"  attention grad {name}: {json.dumps(rec)}")
    return rec


def vq_inputs(N, C, gen, kind):
    """z [N, 16] unit rows and a codebook [C, 16] of the case's kind; the
    rows whose ids must equal the float64 argmax exactly (near ties)."""
    dev = "cuda"
    z = torch.randn((N, 16), generator=gen, device=dev)
    z = z / z.norm(dim=-1, keepdim=True)
    e = torch.randn((C, 16), generator=gen, device=dev)
    e = e / e.norm(dim=-1, keepdim=True)
    tie_rows = None
    if kind == "identical":
        e = e[:1].expand(C, 16).contiguous()          # every code equal -> id 0
    elif kind == "duplicates":
        # every code appears twice more, later in the book: the lowest index must win
        third = C // 3
        e = torch.cat([e[:third], e[:third], e[:third]]).contiguous()
    elif kind == "norms":
        # norms from 0.1 to 10, log-uniform: the codebook is never normalised
        e = e * torch.exp(torch.empty((C, 1), device=dev).uniform_(math.log(0.1), math.log(10.0),
                                                                   generator=gen))
    elif kind == "near_tie":
        # per row of a set with distinct best codes, a twin of the best code
        # (taken from the codes that are nobody's best) scores 1e-6..1e-3
        # below it: beyond VQ_MARGIN, inside the TF32 screen's window
        best = (z.double() @ e.double().t()).argmax(dim=1)
        first = torch.full((C,), N, dtype=torch.long, device=dev)
        first.scatter_reduce_(0, best, torch.arange(N, device=dev), reduce="amin")
        rows = first[first < N][: N // 2]
        free = torch.ones(C, dtype=torch.bool, device=dev)
        free[best] = False
        twins = free.nonzero()[:, 0]
        twins = twins[torch.randperm(twins.numel(), generator=gen, device=dev)][: rows.numel()]
        rows = rows[: twins.numel()]
        delta = 10.0 ** torch.empty((rows.numel(), 1), device=dev).uniform_(-6, -3, generator=gen)
        e[twins] = e[best[rows]] - delta * z[rows]
        tie_rows = rows
    return z, e.contiguous(), tie_rows


def vq_case(vk, name, N, C, gen, timed, kind="random", time_once=False, count=False):
    z, e, tie_rows = vq_inputs(N, C, gen, kind)
    before = vk.launch_count
    ids = vk.vq_argmax(z, e)
    torch.cuda.synchronize()
    if vk.launch_count != before + 1:
        raise RuntimeError(f"{name}: the wrapper did not count its launch")
    if ids.dtype != torch.int32 or tuple(ids.shape) != (N,):
        raise RuntimeError(f"{name}: bad output {ids.dtype} {tuple(ids.shape)}")
    scores = z.double() @ e.double().t()
    chosen = scores.gather(1, ids.long()[:, None])[:, 0]
    top2 = torch.topk(scores, 2, dim=-1).values
    err = (top2[:, 0] - chosen).abs().max().item()
    rec = {"case": name, "shape": [N, C, 16], "kind": kind, "max_abs_err": err}
    if kind == "identical":
        if int(ids.abs().max()) != 0:
            raise RuntimeError(f"{name}: identical codes must give id 0")
    elif kind == "duplicates":
        # codes [third, 3*third) each repeat an earlier code bit for bit, so
        # the first-occurrence rule keeps every id below third, exactly
        if int((ids >= C // 3).sum()) != 0:
            raise RuntimeError(f"{name}: a duplicate code beat its first occurrence")
        if err > VQ_MARGIN:
            raise RuntimeError(f"{name}: chosen score {err} below the best")
    else:
        plain = vk.vq_argmax_plain(z, e)
        # the fp32 sums' error grows with the norms: the margin scales with the largest
        margin_tol = VQ_MARGIN * max(1.0, float(e.norm(dim=-1).max()))
        margin = (top2[:, 0] - top2[:, 1])
        bad = (ids != plain) & (margin >= margin_tol)
        if int(bad.sum()) != 0:
            raise RuntimeError(
                f"{name}: {int(bad.sum())} ids differ from the plain version outside margin {margin_tol}")
        if tie_rows is not None:
            want = scores.argmax(dim=1)
            tie_margin = margin[tie_rows]
            wrong = int((ids[tie_rows].long() != want[tie_rows]).sum())
            rec.update(near_tie_rows=int(tie_rows.numel()),
                       near_tie_margin_min=float(tie_margin.min()),
                       near_tie_margin_max=float(tie_margin.max()),
                       near_tie_ids_wrong=wrong)
            if wrong:
                raise RuntimeError(f"{name}: {wrong} near-tie ids differ from the float64 argmax")
            if float(tie_margin.min()) < VQ_MARGIN * 0.5 or float(tie_margin.max()) > 2e-3:
                raise RuntimeError(f"{name}: the near ties are not in 1e-6..1e-3")
    if count:
        ids_c, rescored = vk.vq_argmax_rescored(z, e)
        if not torch.equal(ids_c, ids):
            raise RuntimeError(f"{name}: the counting launch gave other ids")
        rec.update(rescored_mean=float(rescored.float().mean()), rescored_max=int(rescored.max()))
    if time_once:
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        vk.vq_argmax(z, e)
        end.record()
        torch.cuda.synchronize()
        rec["once_ms"] = start.elapsed_time(end)
    if timed:
        bound, by, fp32_bound = vq_bound(N, C)
        rec.update(
            ms=time_ms(lambda: vk.vq_argmax(z, e)),
            host_paced_ms=time_ms(lambda: vk.vq_argmax(z, e), hold=False),
            plain_ms=time_ms(lambda: vk.vq_argmax_plain(z, e)),
            library_ms=time_ms(lambda: torch.argmax(z @ e.t(), dim=-1)),
            bound_ms=bound, bound_by=by, fp32_bound_ms=fp32_bound)
        rec["share"] = bound / rec["ms"]
    log(f"  vq_argmax {name}: {json.dumps(rec)}")
    return rec


def q8_bound(M, K, N, x_item):
    t_ops = 2.0 * M * K * N / PEAK_INT8_OPS
    t_bytes = (M * K * x_item + K * N + 6 * N + M * N * x_item) / PEAK_BYTES
    return max(t_ops, t_bytes) * 1e3, "operations" if t_ops >= t_bytes else "bytes"


def q8_quantize_bound(M, K, Kp, x_item):
    """The quantize pass alone: read x, write xq and sx."""
    return (M * K * x_item + M * Kp + 4 * M) / PEAK_BYTES * 1e3


def q8_case(q8, name, M, K, N, xdt, bdt, gen, timed, kind=None, plan=None):
    """kind: None, "edge" (an all-zero row and a row of one large value) or
    "rowmax_last" (rows whose maximum lies in the last K tile); plan: a
    forced (bn, splits) instead of plan_q8's."""
    import torch.nn.functional as F

    dev = "cuda"
    x = torch.randn((M, K), generator=gen, device=dev)
    if kind == "edge":
        x[0] = 0.0                    # all-zero row: output = bias
        x[1] *= 1e-3
        x[1, K // 2] = 300.0          # one large value: the rest of the row quantizes to 0
    elif kind == "rowmax_last":
        x[::2, K - 1] = 40.0          # every other row's scale comes from its last K tile
    x = x.to(xdt)
    # the decode quantizes bf16-rounded weights
    w = (torch.randn((N, K), generator=gen, device=dev) * K ** -0.5).to(torch.bfloat16)
    wq, sw = q8.quantize_weight(w)
    b = None if bdt is None else (torch.randn((N,), generator=gen, device=dev) * 0.02).to(bdt)
    p = q8.plan_q8(M, K, N, x.element_size()) if plan is None else q8.Q8Plan(M, K, N, *plan)

    def run():
        if plan is None:
            return q8.q8_matmul(x, wq, sw, b)
        return q8._launch(x, wq, sw, b, torch.empty((M, N), dtype=xdt, device=dev), p)

    before = q8.launch_count
    out = run()
    torch.cuda.synchronize()
    if q8.launch_count != before + 1:
        raise RuntimeError(f"{name}: the wrapper did not count its launch")
    ref = q8.q8_matmul_plain(x, wq, sw, b)
    if out.shape != ref.shape or out.dtype != ref.dtype:
        raise RuntimeError(f"{name}: shape or type differs from the plain version")
    if not torch.isfinite(out.float()).all():
        raise RuntimeError(f"{name}: non-finite output")
    diff = (out.float() - ref.float()).abs()
    err = diff.max().item()
    n_diff = int((diff > 0).sum())
    if xdt == torch.float32 and b is not None:
        if bool((diff > Q8_FP32_BIAS_RTOL * ref.float().abs()).any()):
            raise RuntimeError(f"{name}: kernel differs from the plain version by more than one fp32 ulp")
    elif n_diff:
        raise RuntimeError(f"{name}: {n_diff} values differ from the plain version (max {err})")
    if kind == "edge" and not torch.equal(out[0], b.to(xdt)):
        raise RuntimeError(f"{name}: an all-zero row must give the bias")
    # the first stage alone, against its plain version: every byte and scale
    xq, sx = q8.q8_quantize_rows(x)
    xq_p, sx_p = q8.q8_quantize_rows_plain(x)
    torch.cuda.synchronize()
    if not (torch.equal(xq, xq_p) and torch.equal(sx, sx_p)):
        raise RuntimeError(f"{name}: the quantize pass differs from its plain version")
    rec = {"case": name, "shape": [M, K, N], "dtype": str(xdt).replace("torch.", ""),
           "bias": None if bdt is None else str(bdt).replace("torch.", ""),
           "plan": {"bn": p.bn, "splits": p.splits, "k_tiles": p.k_tiles, "grid": list(p.grid)},
           "max_abs_err": err, "values_differing": n_diff}
    if timed:
        bound, by = q8_bound(M, K, N, x.element_size())
        try:   # the product alone on pre-quantized operands: no quantization, no dequantization
            xq_k = xq_p[:, :K].contiguous()
            library_ms = time_ms(lambda: torch._int_mm(xq_k, wq.t()))
        except RuntimeError as e:
            log(f"    torch._int_mm refused {name}: {str(e).splitlines()[0]}")
            library_ms = None
        wd, bd = w.to(xdt), None if b is None else b.to(xdt)
        rec.update(
            ms=time_ms(run),
            host_paced_ms=time_ms(run, hold=False),
            quantize_ms=time_ms(lambda: q8.q8_quantize_rows(x)),
            quantize_bound_ms=q8_quantize_bound(M, K, p.Kp, x.element_size()),
            plain_ms=time_ms(lambda: q8.q8_matmul_plain(x, wq, sw, b), reps=3, rounds=3),
            library_ms=library_ms,
            bound_ms=bound, bound_by=by)
        rec["share"] = bound / rec["ms"]
        # the dense call the int8 path replaces: F.linear in x's type, unquantized weight
        rec[f"{rec['dtype'].replace('float32', 'fp32').replace('bfloat16', 'bf16')}_ms"] = \
            time_ms(lambda: F.linear(x, wd, bd))
    log(f"  q8_matmul {name}: {json.dumps(rec)}")
    return rec


# launches of each product per cond call of the int8 decode (23 joint blocks,
# the last block's x stream and context qkv, the context embedder, the final
# linear): 191 in all
Q8_PER_COND_CALL = {"x_qkv": 24, "x_proj": 24, "x_fc1": 24, "x_fc2": 24, "context_qkv": 24,
                    "context_proj": 23, "context_fc1": 23, "context_fc2": 23,
                    "context_embedder": 1, "final_layer_linear": 1}


def q8_per_cond_call(recs):
    """q8_matmul device time and bound summed over one cond call's 191
    launches, the context at its largest bucket (M = 1024)."""
    by = {r["case"]: r for r in recs}
    if sum(Q8_PER_COND_CALL.values()) != 191:
        raise RuntimeError("the per-call table must hold 191 launches")
    ms = sum(n * by[c]["ms"] for c, n in Q8_PER_COND_CALL.items())
    bound = sum(n * by[c]["bound_ms"] for c, n in Q8_PER_COND_CALL.items())
    bf16 = sum(n * by[c]["bf16_ms"] for c, n in Q8_PER_COND_CALL.items())
    log(f"  q8_matmul per cond call (191 launches, context M = 1024): {ms:.4f} ms device "
        f"(bound {bound:.4f} ms, share {bound / ms:.3f}; bf16 F.linear {bf16:.4f} ms)")


def q8_sweep(q8):
    """Every plan's device time at the main path's shapes: the measurements
    the planner's choices are checked against."""
    gen = torch.Generator(device="cuda")
    gen.manual_seed(99)
    shapes = [("x_qkv", 512, 1536, 4608), ("x_proj", 512, 1536, 1536), ("x_fc1", 512, 1536, 6144),
              ("x_fc2", 512, 6144, 1536), ("context_qkv", 1024, 1536, 4608),
              ("context_proj", 1024, 1536, 1536), ("context_fc1", 1024, 1536, 6144),
              ("context_fc2", 1024, 6144, 1536), ("context_embedder", 1024, 16, 1536),
              ("final_layer_linear", 512, 1536, 64), ("context_256_fc1", 256, 1536, 6144),
              ("renderer_x_qkv", 2048, 1536, 4608), ("renderer_context_fc2", 4096, 6144, 1536)]
    for name, M, K, N in shapes:
        x = torch.randn((M, K), generator=gen, device="cuda").to(torch.bfloat16)
        wq, sw = q8.quantize_weight(torch.randn((N, K), generator=gen, device="cuda"))
        b = torch.zeros((N,), dtype=torch.bfloat16, device="cuda")
        out = torch.empty((M, N), dtype=torch.bfloat16, device="cuda")
        chosen = q8.plan_q8(M, K, N, 2)
        times = {}
        for bn in q8.BNS:
            for splits in (1, 2, 3, 4, 6, 8, 12):
                if splits <= chosen.k_tiles:
                    plan = q8.Q8Plan(M, K, N, bn, splits)
                    times[f"{bn}/{splits}"] = time_ms(lambda: q8._launch(x, wq, sw, b, out, plan))
        best = min(times, key=times.get)
        key = f"{chosen.bn}/{chosen.splits}"
        row = {"case": name, "shape": [M, K, N], "chosen": key, "chosen_ms": times.get(key),
               "best": best, "best_ms": times[best], "ms": times}
        log(f"  q8 sweep {json.dumps(row)}")


def conv_bound(B, H, W, C, dtype):
    item = 2 if dtype == torch.bfloat16 else 4
    flops = 2.0 * B * H * W * 27 * C
    nbytes = B * H * W * 3 * item + 28 * C * 4 + B * H * W * C * item
    t_ops = flops / (PEAK_BF16_FLOPS if dtype == torch.bfloat16 else PEAK_FP32_FLOPS)
    t_bytes = nbytes / PEAK_BYTES
    return max(t_ops, t_bytes) * 1e3, "operations" if t_ops >= t_bytes else "bytes"


def conv_case(c3, name, B, H, W, C, dtype, gen, timed, batch_slice=False):
    """batch_slice: x is x[1:] of a batch one larger, so it starts
    H * W * 3 values into its memory (2 bytes into a 4-byte word in bf16 at
    odd H * W)."""
    import torch.nn.functional as F

    dev = "cuda"
    x = torch.randn((B + batch_slice, H, W, 3), generator=gen, device=dev).to(dtype)[int(batch_slice):]
    w = torch.randn((C, 3, 3, 3), generator=gen, device=dev) * 0.2
    b = torch.randn((C,), generator=gen, device=dev) * 0.1
    before = c3.launch_count
    out = c3.conv3ch_3x3(x, w, b)
    torch.cuda.synchronize()
    if c3.launch_count != before + 1:
        raise RuntimeError(f"{name}: the wrapper did not count its launch")
    ref = c3.conv3ch_3x3_plain(x, w, b)
    if out.shape != ref.shape or out.dtype != ref.dtype:
        raise RuntimeError(f"{name}: shape or type differs from the plain version")
    if not torch.isfinite(out.float()).all():
        raise RuntimeError(f"{name}: non-finite output")
    diff = (out.float() - ref.float()).abs()
    err = diff.max().item()
    rtol, atol = CONV_TOL[dtype]
    if bool((diff > atol + rtol * ref.float().abs()).any()):
        raise RuntimeError(f"{name}: kernel differs from the plain version by {err} "
                           f"(rtol {rtol}, atol {atol})")
    rec = {"case": name, "shape": [B, H, W, 3, C], "dtype": str(dtype).replace("torch.", ""),
           "max_abs_err": err, "rtol": rtol, "atol": atol, "x_offset_bytes": x.data_ptr() % 16,
           "smem": c3._lib().stk_conv3ch_smem(W, C, 1 if dtype == torch.bfloat16 else 0)}
    if timed:
        bound, by = conv_bound(B, H, W, C, dtype)
        xc = x.permute(0, 3, 1, 2)            # NCHW view of NHWC memory: channels_last
        wl = w.to(dtype).contiguous(memory_format=torch.channels_last)
        bl = b.to(dtype)
        prev = torch.backends.cudnn.allow_tf32
        torch.backends.cudnn.allow_tf32 = False   # the same function: fp32 stays fp32
        try:
            library_ms = time_ms(lambda: F.conv2d(xc, wl, bl, padding=1))
        finally:
            torch.backends.cudnn.allow_tf32 = prev
        rec.update(
            ms=time_ms(lambda: c3.conv3ch_3x3(x, w, b)),
            host_paced_ms=time_ms(lambda: c3.conv3ch_3x3(x, w, b), hold=False),
            plain_ms=time_ms(lambda: c3.conv3ch_3x3_plain(x, w, b), reps=3, rounds=3),
            library_ms=library_ms, bound_ms=bound, bound_by=by)
        rec["share"] = bound / rec["ms"]
    log(f"  conv3ch_3x3 {name}: {json.dumps(rec)}")
    return rec


def kernel_phase():
    from selftoktokenizer_tpu_torch.ops import conv3ch as c3
    from selftoktokenizer_tpu_torch.ops import flash_attention as fa
    from selftoktokenizer_tpu_torch.ops import q8_matmul as q8
    from selftoktokenizer_tpu_torch.ops import vq_kernels as vk

    gen = torch.Generator(device="cuda")
    gen.manual_seed(1234)
    bf, f32 = torch.bfloat16, torch.float32
    attn = [
        # (name, B, H, Lq, Lk, D, dtype, mask, timed): the main path's shapes first
        ("decode_joint_bf16_masked", 2, 24, 768, 768, 64, bf, "prefix", True),
        ("encoder_query_bf16", 8, 8, 512, 768, 64, bf, None, True),
        ("decode_uncond_bf16", 2, 24, 256, 256, 64, bf, None, True),
        # the renderer at batch 8: context rows over the context keys, x rows over all
        ("renderer_context_bf16", 8, 24, 512, 512, 64, bf, "ones", True),
        ("renderer_x_bf16", 8, 24, 256, 768, 64, bf, "ones", True),
        ("decode_joint_fp32_masked", 2, 24, 768, 768, 64, f32, "prefix", True),
        # training, fp32 at batch 4: the tokenizer's joint attention, the
        # renderer's x rows (its context rows are qkv views, below)
        ("train_joint_fp32_masked", 4, 24, 768, 768, 64, f32, "prefix", True),
        ("train_renderer_x_fp32", 4, 24, 256, 768, 64, f32, "ones", True),
        # sharded training: the tokenizer's joint attention on one rank's
        # heads, the decoder split over tensor = 2 and 4
        ("train_joint_tp2_fp32_masked", 4, 12, 768, 768, 64, f32, "prefix", True),
        ("train_joint_tp4_fp32_masked", 4, 6, 768, 768, 64, f32, "prefix", True),
        # the decode's other context buckets: joint lengths 384, 512 and 640
        ("decode_joint_384_bf16_masked", 2, 24, 384, 384, 64, bf, "prefix", True),
        ("decode_joint_512_bf16_masked", 2, 24, 512, 512, 64, bf, "prefix", True),
        ("decode_joint_640_bf16_masked", 2, 24, 640, 640, 64, bf, "prefix", True),
        # the zoo: the register decoder's uncond call (4 register keys active,
        # 512 context keys masked, 256 x keys; 772 keys, no multiple of 64),
        # the batched CFG trunk at 2B (the uncond half's context keys all
        # masked), RenderDiT at batch 8 (one call a block), the K=1024
        # encoder's query attention at 'default'
        ("cfg_inference_registers_bf16", 1, 24, 772, 772, 64, bf, "uncond_registers", True),
        ("cfg_batched_2b_bf16", 4, 24, 768, 768, 64, bf, "cfg_batched", True),
        ("renderdit_bf16", 8, 24, 768, 768, 64, bf, "renderdit", True),
        ("encoder_query_k1024_bf16", 8, 8, 1024, 1280, 64, bf, None, True),
        # the 512 px encode's query attention at 'default': 512 queries over
        # 1024 image + 512 query keys
        ("encoder_query_512px_bf16", 8, 8, 512, 1536, 64, bf, None, True),
        # the multi-resolution tokenizer's loss at batch 4, fp32: 2 x 512
        # interleaved context keys (a prefix active) and 256 x keys
        ("multi_tokenizer_joint_fp32_masked", 4, 24, 1280, 1280, 64, f32, "prefix", True),
        # 512 px: the decode joint is 512 context + 1024 x rows; 4608 is the
        # longest bucket of the JAX package's 512 px notes (4096 x rows)
        ("decode_joint_512px_bf16_masked", 2, 24, 1536, 1536, 64, bf, "prefix1024", True),
        ("joint_4608_bf16_masked", 2, 24, 4608, 4608, 64, bf, "prefix4096", True),
        ("ragged_bf16", 2, 3, 200, 333, 64, bf, "random", False),
        # Lq and Lk a multiple of neither tile: the last query tile holds 13
        # rows, the last key tile 1 key
        ("ragged_tiles_bf16", 1, 2, 77, 129, 64, bf, "prefix", False),
        ("ragged_fp32", 2, 3, 200, 333, 64, f32, "random", False),
        ("fully_masked_row_bf16", 2, 4, 128, 192, 64, bf, "full_row", False),
        ("fully_masked_row_fp32", 2, 4, 128, 192, 64, f32, "full_row", False),
        ("head_dim_128_bf16", 1, 4, 130, 257, 128, bf, "random", False),
        ("head_dim_128_fp32", 1, 4, 130, 257, 128, f32, "random", False),
        # the split-TF32 forward: Lq and Lk a multiple of neither tile; whole
        # masked key tiles left out beside a fully masked row
        ("ragged_tiles_fp32", 1, 2, 77, 129, 64, f32, "prefix", False),
        ("masked_tiles_fp32", 2, 4, 130, 330, 64, f32, "tiles", False),
        ("masked_tiles_head_dim_128_fp32", 2, 4, 130, 330, 128, f32, "tiles", False),
    ]
    # the strided views of the qkv split, passed straight through: the
    # renderer's context rows and the uncond x-only call
    attn_qkv = [
        ("qkv_views_renderer_context_bf16", 8, 24, 512, 512, 64, bf, "ones", True),
        ("qkv_views_uncond_bf16", 2, 24, 256, 256, 64, bf, None, True),
        ("qkv_views_train_renderer_context_fp32", 4, 24, 512, 512, 64, f32, "ones", True),
        ("qkv_views_ragged_bf16_masked", 2, 3, 200, 200, 64, bf, "random", False),
    ]
    if 77 % fa.BM == 0 or 129 % fa.BN == 0:
        raise RuntimeError("ragged_tiles_bf16 must be ragged in both tiles")
    attn_recs = [attn_case(fa, *c[:8], gen, c[8]) for c in attn]
    attn_recs += [attn_case(fa, *c[:8], gen, c[8], layout="qkv") for c in attn_qkv]
    # scores up to about 30 (q and k of std 2.5), where fp32 rounding of the
    # scores and of the P V sums shows most, at the fp32 tolerance
    attn_recs += [attn_case(fa, f"large_scores_head_dim_{D}_fp32", 2, 4, 300, 300, D, f32, None,
                            gen, False, qk_std=2.5) for D in (64, 128)]
    attn_grad = [
        # the training path's calls, then the edges
        ("grad_train_joint_fp32_masked", 4, 24, 768, 768, 64, f32, "prefix", "dense", True),
        ("grad_train_renderer_context_fp32", 4, 24, 512, 512, 64, f32, "ones", "qkv", True),
        ("grad_train_renderer_x_fp32", 4, 24, 256, 768, 64, f32, "ones", "dense", True),
        ("grad_multi_tokenizer_joint_fp32_masked", 4, 24, 1280, 1280, 64, f32, "prefix", "dense",
         True),
        ("grad_ragged_bf16", 2, 3, 200, 333, 64, bf, "random", "dense", False),
        ("grad_ragged_fp32", 2, 3, 200, 333, 64, f32, "random", "dense", False),
        ("grad_ragged_tiles_fp32", 1, 2, 77, 129, 64, f32, "prefix", "dense", False),
        ("grad_ragged_tiles_bf16", 1, 2, 77, 129, 64, bf, "prefix", "dense", False),
        ("grad_fully_masked_row_fp32", 2, 4, 128, 192, 64, f32, "full_row", "dense", False),
        ("grad_fully_masked_row_bf16", 2, 4, 128, 192, 64, bf, "full_row", "dense", False),
        ("grad_masked_tiles_fp32", 2, 4, 130, 330, 64, f32, "tiles", "dense", False),
        ("grad_masked_tiles_bf16", 2, 4, 130, 330, 64, bf, "tiles", "dense", False),
        ("grad_head_dim_128_fp32", 1, 4, 130, 257, 128, f32, "random", "dense", False),
        ("grad_head_dim_128_bf16", 1, 4, 130, 257, 128, bf, "random", "dense", False),
        ("grad_masked_tiles_head_dim_128_fp32", 2, 4, 130, 330, 128, f32, "tiles", "dense",
         False),
        ("grad_qkv_views_ragged_fp32", 2, 3, 200, 200, 64, f32, "random", "qkv", False),
        ("grad_qkv_views_ragged_bf16", 2, 3, 200, 200, 64, bf, "random", "qkv", False),
    ]
    attn_grad_recs = [attn_grad_case(fa, *c, gen) for c in attn_grad]
    attn_grad_recs += [attn_grad_case(fa, f"grad_large_scores_head_dim_{D}_fp32", 2, 4, 300, 300, D,
                                      f32, None, "dense", False, gen, qk_std=2.5) for D in (64, 128)]
    vq = [
        # (name, N, C, timed, kind, time once, count re-scores)
        ("flagship_b8", 4096, 32768, True, "random", False, True),
        ("flagship_b32", 16384, 32768, True, "random", False, True),
        # the zoo at batch 8: Enc-L/8 (K = 24 groups of 16 patches), K = 1024
        ("vit_enc_l8_b8", 3072, 32768, True, "random", False, True),
        ("k1024_b8", 8192, 32768, True, "random", False, True),
        # measure_k1024's encode: K = 1024 at batch 32
        ("k1024_b32", 32768, 32768, True, "random", False, True),
        ("ragged", 1000, 5001, False, "random", False, False),
        ("norms_0.1_to_10", 4096, 32768, False, "norms", False, True),
        ("near_tie", 4096, 32768, False, "near_tie", False, True),
        ("identical_codes", 300, 4096, False, "identical", False, False),
        # every code is a candidate: the slowest case, timed once
        ("identical_codes_flagship", 4096, 32768, False, "identical", True, True),
        ("duplicate_codes", 777, 3 * 1024, False, "duplicates", False, False),
    ]
    vq_recs = [vq_case(vk, *c[:3], gen, *c[3:]) for c in vq]
    q8_cases = [
        # (name, M, K, N, x type, bias type, timed, kind, forced (bn, splits)):
        # the int8 decode's ten products first (batch 2: x stream M = 512,
        # context M = 2*Lc <= 1024), then the renderer's (batch 8: x stream
        # M = 2048, context M = 4096, its context embedder in fp32)
        ("x_qkv", 512, 1536, 4608, bf, bf, True, None, None),
        ("x_proj", 512, 1536, 1536, bf, bf, True, None, None),
        ("x_fc1", 512, 1536, 6144, bf, bf, True, None, None),
        ("x_fc2", 512, 6144, 1536, bf, bf, True, None, None),
        ("context_qkv", 1024, 1536, 4608, bf, bf, True, None, None),
        ("context_proj", 1024, 1536, 1536, bf, bf, True, None, None),
        ("context_fc1", 1024, 1536, 6144, bf, bf, True, None, None),
        ("context_fc2", 1024, 6144, 1536, bf, bf, True, None, None),
        ("context_embedder", 1024, 16, 1536, bf, bf, True, None, None),
        ("final_layer_linear", 512, 1536, 64, bf, bf, True, None, None),
        ("renderer_context_embedder_fp32", 4096, 16, 1536, f32, bf, True, None, None),
        ("renderer_x_qkv", 2048, 1536, 4608, bf, bf, True, None, None),
        ("renderer_context_fc2", 4096, 6144, 1536, bf, bf, True, None, None),
        ("ragged_edge_rows_bf16", 300, 200, 500, bf, bf, False, "edge", None),
        ("ragged_edge_rows_fp32", 300, 200, 500, f32, f32, False, "edge", None),
        ("unaligned_k_no_bias", 33, 37, 70, bf, None, False, None, None),
        ("rowmax_in_last_k_tile", 512, 1536, 1536, bf, bf, False, "rowmax_last", None),
        # K splits that do not divide the K tiles: 10 over 4 (3, 3, 2, 2), 32
        # over 7 (ragged M and N, fp32), 48 over 5 (the widest tile), 12 over
        # 5 with a tile width of 96 and ragged M, N and no bias
        ("uneven_split_k", 256, 1280, 256, bf, bf, False, None, (128, 4)),
        ("uneven_split_k_fp32", 300, 4000, 500, f32, f32, False, "edge", (64, 7)),
        ("uneven_split_k_wide", 512, 6144, 1536, bf, bf, False, None, (192, 5)),
        ("uneven_split_k_bn96_ragged", 200, 1536, 333, bf, None, False, None, (96, 5)),
        # a tile width of 144 over ragged M and N
        ("bn144_ragged_fp32", 200, 200, 500, f32, f32, False, "edge", (144, 1)),
    ]
    for c in q8_cases:
        if c[0].startswith("uneven") and q8.Q8Plan(*c[1:4], *c[8]).k_tiles % c[8][1] == 0:
            raise RuntimeError(f"{c[0]}: the K tiles must not divide evenly among the splits")
    q8_recs = [q8_case(q8, *c[:6], gen, c[6], c[7], c[8]) for c in q8_cases]
    q8_per_cond_call(q8_recs)
    conv_cases = [
        # the VAE encoder's conv_in at batch 8 (not wired: no path runs it)
        ("vae_conv_in_bf16", 8, 256, 256, 128, bf, True),
        ("vae_conv_in_fp32", 8, 256, 256, 128, f32, True),
        ("vae_conv_in_b1_bf16", 1, 256, 256, 128, bf, True),
        ("vae_conv_in_b1_fp32", 1, 256, 256, 128, f32, True),
        ("vae_conv_in_b32_bf16", 32, 256, 256, 128, bf, True),
        ("vae_conv_in_b32_fp32", 32, 256, 256, 128, f32, True),
        ("ragged_bf16", 2, 37, 29, 20, bf, False),
        ("ragged_fp32", 2, 37, 29, 20, f32, False),
        # ragged widths (odd: bf16 rows start on odd 2-byte offsets), C = 20
        # and 256, a single row
        ("w31_c20_bf16", 3, 17, 31, 20, bf, False),
        ("w31_c20_fp32", 3, 17, 31, 20, f32, False),
        ("w257_c256_bf16", 2, 9, 257, 256, bf, False),
        ("w257_c256_fp32", 2, 9, 257, 256, f32, False),
        ("h1_bf16", 4, 1, 64, 128, bf, False),
        ("h1_fp32", 4, 1, 64, 128, f32, False),
        # channels past what one pass of the kernel holds: fp32 above 1024
        # (threads take 4-channel groups in turn), bf16 whose warps' 16 x C
        # output tiles do not fit (stored 64 channels at a time)
        ("wide_c1500_fp32", 2, 5, 20, 1500, f32, False),
        ("wide_c1000_bf16", 2, 5, 37, 1000, bf, False),
    ]
    conv_recs = [conv_case(c3, *c[:6], gen, c[6]) for c in conv_cases]
    # x[1:] of a [2, 37, 29, 3] batch: it starts 6,438 bytes in (bf16), not
    # on a 4-byte word
    for dtype in (bf, f32):
        conv_recs.append(conv_case(c3, f"batch_slice_{str(dtype)[6:]}", 1, 37, 29, 20, dtype,
                                   gen, False, batch_slice=True))
    if conv_recs[-2]["x_offset_bytes"] % 4 != 2:
        raise RuntimeError("batch_slice_bfloat16 must start 2 bytes into a word")
    return attn_recs, attn_grad_recs, vq_recs, q8_recs, conv_recs


# ------------------------------------------------------------- main path ---

def profile_decode(pipe, ids, noise, warm_s, label):
    """Device time by kernel over one warm decode (torch.profiler), and the
    device's busy share of the un-profiled warm wall time."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        pipe.decoding(ids, noise=noise, cfg_scale=1.0)
        torch.cuda.synchronize()

    def dev_us(e):
        return getattr(e, "self_device_time_total", None) or getattr(e, "self_cuda_time_total", 0)

    # kernel rows only: the operator rows repeat their kernels' device time
    rows = [(dev_us(e), e.count, e.key) for e in prof.key_averages()
            if e.device_type == DeviceType.CUDA and dev_us(e) > 0]
    total = sum(r[0] for r in rows)
    if total <= 0:
        raise RuntimeError("torch.profiler recorded no device time")
    rows.sort(reverse=True)
    log(f"  profile of one warm {label} decode (batch {ids.shape[0]}, 50 steps): device busy "
        f"{total / 1e6:.3f} s of {warm_s:.3f} s wall = {total / 1e6 / warm_s:.3f}; "
        f"{sum(r[1] for r in rows)} device kernels")
    attn_rows = [r for r in rows if "flash_bf16_kernel" in r[2] or "flash_tf32_fwd_kernel" in r[2]]
    if attn_rows:
        a_us = sum(r[0] for r in attn_rows)
        log(f"    attention kernel: {a_us / 1e3:.2f} ms ({a_us / total:.3f} of device time) over "
            f"{sum(r[1] for r in attn_rows)} launches")
    q8_rows = [r for r in rows if "q8_matmul" in r[2]]
    if q8_rows:
        q8_us = sum(r[0] for r in q8_rows)
        log(f"    q8_matmul kernels together: {q8_us / 1e3:.2f} ms ({q8_us / total:.3f} of device "
            f"time) over {sum(r[1] for r in q8_rows)} launches")
    for us, n, key in rows[:12]:
        log(f"    {us / 1e3:9.2f} ms {us / total:6.3f} x{n:<6d} {key[:110]}")


# launch counts, in this order; "flash_sdpa_key_mask" counts every forward
# launch, "flash_sdpa_key_mask_fp32" the fp32 ones among them
KERNEL_NAMES = ("vq_argmax", "flash_sdpa_key_mask", "q8_matmul", "conv3ch_3x3",
                "flash_sdpa_key_mask_fp32", "flash_sdpa_key_mask_backward")


def _modules():
    from selftoktokenizer_tpu_torch.ops import conv3ch as c3
    from selftoktokenizer_tpu_torch.ops import flash_attention as fa
    from selftoktokenizer_tpu_torch.ops import q8_matmul as q8
    from selftoktokenizer_tpu_torch.ops import vq_kernels as vk
    return vk, fa, q8, c3


def counts():
    vk, fa, q8, c3 = _modules()
    return (vk.launch_count, fa.launch_count, q8.launch_count, c3.launch_count,
            fa.fp32_launch_count, fa.backward_launch_count)


def reset_counts():
    for m in _modules():
        m.launch_count = 0
    _modules()[1].fp32_launch_count = _modules()[1].backward_launch_count = 0


def timed(fn):
    torch.cuda.synchronize()
    t = time.time()
    out = fn()
    torch.cuda.synchronize()
    return out, time.time() - t


def warm(fn, n):
    ts = sorted(timed(fn)[1] for _ in range(n))
    return ts[len(ts) // 2]


def check_images(img, b):
    if tuple(img.shape) != (b, 256, 256, 3) or not torch.isfinite(img).all() \
            or float(img.min()) < 0 or float(img.max()) > 1:
        raise RuntimeError(f"bad images: {tuple(img.shape)}")


def psnr(a, b):
    mse = float(((a.float() - b.float()) ** 2).mean())
    return float("inf") if mse == 0 else 10.0 * math.log10(1.0 / mse)


def release():
    """Give back the device memory of a pipeline the caller has deleted."""
    gc.collect()
    torch.cuda.empty_cache()


def check_decoder_widths(pipe, renderer=False):
    enc_cfg, dec_cfg = pipe.tcfg.encoder, pipe.tcfg.decoder
    widths = (enc_cfg.depth, enc_cfg.query_dim, enc_cfg.K, enc_cfg.codebook_size,
              dec_cfg.depth, dec_cfg.hidden_size, dec_cfg.num_heads, dec_cfg.renderer)
    if widths != (16, 512, 512, 32768, 24, 1536, 24, renderer):
        raise RuntimeError(f"not the flagship widths: {widths}")


def build_pipeline(cfg, decode_dtype, encode_only=False):
    """cfg: a config file's path or a config (``zoo_config``)."""
    from selftoktokenizer_tpu_torch.core.config import load_config
    from selftoktokenizer_tpu_torch.pipeline import SelftokPipeline

    torch.cuda.reset_peak_memory_stats()
    t0 = time.time()
    name = cfg.rsplit("/", 1)[-1] if isinstance(cfg, str) else \
        f"{cfg.tokenizer.params.enc} + {cfg.tokenizer.params.model}"
    # non-zero adaLN and biases: the reference init zeroes every attention gate,
    # which would hide a wrong attention kernel from every end-to-end check;
    # one seed, so every pipeline of the run holds the same weights
    pipe = SelftokPipeline(load_config(cfg) if isinstance(cfg, str) else cfg, datasize=256,
                           steps=50, decode_dtype=decode_dtype, encode_precision="highest",
                           seed=0, zero_init_std=0.02, encode_only=encode_only)
    torch.cuda.synchronize()
    n_params = sum(p.numel() for m in (pipe.encoder, pipe.model, pipe.vae) if m is not None
                   for p in list(m.parameters()) + list(m.buffers()))
    log(f"  pipeline {name} {decode_dtype} built in "
        f"{time.time() - t0:.1f} s: {n_params / 1e9:.2f} B weights, "
        f"{torch.cuda.max_memory_allocated() / 2**30:.1f} GiB peak")
    return pipe


def bf16_path(card, do_profile):
    """The serving path: flagship encode at both tiers and the bf16 decode."""
    from selftoktokenizer_tpu_torch.core.config import FLAGSHIP_CONFIG

    pipe = build_pipeline(FLAGSHIP_CONFIG, torch.bfloat16)
    check_decoder_widths(pipe)
    enc_cfg, dec_cfg = pipe.tcfg.encoder, pipe.tcfg.decoder

    gen = torch.Generator(device="cuda")
    gen.manual_seed(7)
    images = torch.rand((8, 256, 256, 3), generator=gen, device="cuda") * 2 - 1
    noise2 = torch.randn((2, 32, 32, 16), generator=gen, device="cuda")
    noise1 = noise2[:1].clone()
    B, K, depth, steps = 8, 512, dec_cfg.depth, 50

    def check_ids(ids, b):
        if ids.dtype != torch.int32 or tuple(ids.shape) != (b, K) \
                or int(ids.min()) < 0 or int(ids.max()) >= 32768:
            raise RuntimeError(f"bad token ids: {ids.dtype} {tuple(ids.shape)}")

    # warm-up outside the counted run (cuDNN autotune, cuBLAS handles)
    pipe.encoding(images[:1])

    # ---- the counted run: every count set to 0 just before, read just after
    reset_counts()
    ids_hi, t_hi = timed(lambda: pipe.encoding(images))
    c1 = counts()
    ids_high, t_high = timed(lambda: pipe.encoding(images, precision="high"))
    c1h = counts()
    ids_def, t_def = timed(lambda: pipe.encoding(images, precision="default"))
    c2 = counts()
    (img2, lat2), t_dec = timed(lambda: pipe.decoding(
        ids_hi[:2], noise=noise2, cfg_scale=1.0, return_latents=True))
    c3_ = counts()
    (img1, lat1), t_cfg = timed(lambda: pipe.decoding(
        ids_hi[:1], noise=noise1, cfg_scale=2.0, return_latents=True))
    c4 = counts()

    expect = [(1, 0, 0, 0, 0, 0), (2, 0, 0, 0, 0, 0), (3, enc_cfg.depth, 0, 0, 0, 0),
              (3, enc_cfg.depth + depth * steps, 0, 0, 0, 0),
              (3, enc_cfg.depth + 3 * depth * steps, 0, 0, 0, 0)]
    if [c1, c1h, c2, c3_, c4] != expect:
        raise RuntimeError(f"launch counts {[c1, c1h, c2, c3_, c4]} differ from the path's {expect}")
    check_ids(ids_hi, B)
    check_ids(ids_high, B)
    check_ids(ids_def, B)
    check_images(img2, 2)
    check_images(img1, 1)
    segs = pipe._decode_segments()
    if segs is None or len(segs) < 2:
        raise RuntimeError("the flagship decode must be bucketed")
    log(f"  decode buckets (start, end, context length): {segs}")

    # ---- the same calls with the plain versions forced
    before = counts()
    ids_hi_p = pipe.encoding(images, kernels="plain")
    ids_high_p = pipe.encoding(images, precision="high", kernels="plain")
    ids_def_p = pipe.encoding(images, precision="default", kernels="plain")
    _, lat2_p = pipe.decoding(ids_hi[:2], noise=noise2, cfg_scale=1.0,
                              kernels="plain", return_latents=True)
    _, lat1_p = pipe.decoding(ids_hi[:1], noise=noise1, cfg_scale=2.0,
                              kernels="plain", return_latents=True)
    torch.cuda.synchronize()
    if counts() != before:
        raise RuntimeError("kernels='plain' launched a kernel")
    _, margins = pipe.encoding_margins(images, kernels="plain")
    diff_hi = ids_hi != ids_hi_p
    if int((diff_hi & (margins >= VQ_MARGIN)).sum()) != 0:
        raise RuntimeError("'highest' encode: kernel ids differ from plain ids outside the margin")
    diff_high = ids_high != ids_high_p
    if int((diff_high & (margins >= HIGH_TIER_MARGIN)).sum()) != 0:
        raise RuntimeError("'high' encode: kernel ids differ from plain ids outside the margin")
    diff_def = ids_def != ids_def_p
    if int((diff_def & (margins >= DEFAULT_TIER_MARGIN)).sum()) != 0:
        raise RuntimeError("'default' encode: kernel ids differ from plain ids outside the margin")
    agree_def = 1.0 - diff_def.float().mean().item()
    if agree_def < 0.5:
        raise RuntimeError(f"'default' encode: only {agree_def:.3f} of ids agree with the plain path")
    e2 = (lat2 - lat2_p).abs().max().item()
    e1 = (lat1 - lat1_p).abs().max().item()
    log(f"  kernels vs forced plain: 'highest' ids differing {int(diff_hi.sum())}/{diff_hi.numel()}, "
        f"'high' ids differing {int(diff_high.sum())} (agreeing with 'highest' "
        f"{1.0 - (ids_high != ids_hi).float().mean().item():.4f}), "
        f"'default' ids agreeing {agree_def:.4f} "
        f"(share of tokens with margin >= {DEFAULT_TIER_MARGIN}: "
        f"{(margins >= DEFAULT_TIER_MARGIN).float().mean().item():.4f}), "
        f"latents max abs diff {e2:.4g} (cfg 1.0) {e1:.4g} (cfg 2.0), "
        f"latent abs max {lat2.abs().max().item():.3g}")
    if not (torch.isfinite(lat2).all() and torch.isfinite(lat1).all()):
        raise RuntimeError("non-finite latents")
    if e2 > LATENT_TOL or e1 > LATENT_TOL:
        raise RuntimeError(f"decode latents differ from the plain path by {max(e1, e2)} > {LATENT_TOL}")

    # the counted calls above were each path's first; time warm repeats too
    w_hi = warm(lambda: pipe.encoding(images), 3)
    w_high = warm(lambda: pipe.encoding(images, precision="high"), 3)
    w_def = warm(lambda: pipe.encoding(images, precision="default"), 3)
    w_dec = warm(lambda: pipe.decoding(ids_hi[:2], noise=noise2, cfg_scale=1.0), 2)
    w_cfg = warm(lambda: pipe.decoding(ids_hi[:1], noise=noise1, cfg_scale=2.0), 1)
    log(f"encode 'highest': {B / w_hi:.2f} images/s (batch {B}, {w_hi * 1e3:.1f} ms warm, "
        f"{t_hi * 1e3:.1f} ms first call) on {card}")
    log(f"encode 'high': {B / w_high:.2f} images/s (batch {B}, {w_high * 1e3:.1f} ms warm, "
        f"{t_high * 1e3:.1f} ms first call) on {card}")
    log(f"encode 'default': {B / w_def:.2f} images/s (batch {B}, {w_def * 1e3:.1f} ms warm, "
        f"{t_def * 1e3:.1f} ms first call) on {card}")
    log(f"decode bf16, 50 steps, cfg 1.0: {w_dec / 2:.3f} s/image (batch 2, {w_dec:.3f} s warm, "
        f"{t_dec:.3f} s first call) on {card}")
    log(f"decode bf16, 50 steps, cfg 2.0: {w_cfg:.3f} s/image (batch 1, warm; "
        f"{t_cfg:.3f} s first call) on {card}")
    if do_profile:
        profile_decode(pipe, ids_hi[:2], noise2, w_dec, "bf16")
    ref = {"ids": ids_hi, "images": images, "noise2": noise2, "noise1": noise1,
           "lat2": lat2, "lat1": lat1, "img2": img2, "img1": img1}
    del pipe
    release()
    return c4, ref


def int8_path(card, ref, do_profile):
    """The int8 decode: the same seeded weights, cast to bf16 and quantized."""
    from selftoktokenizer_tpu_torch.core.config import FLAGSHIP_CONFIG
    from selftoktokenizer_tpu_torch.ops import q8_matmul as q8

    pipe = build_pipeline(FLAGSHIP_CONFIG, "int8")
    check_decoder_widths(pipe)
    depth, steps = pipe.tcfg.decoder.depth, 50
    ids, noise2, noise1 = ref["ids"], ref["noise2"], ref["noise1"]
    n_q8 = sum(isinstance(m, q8.Q8Linear) for m in pipe.model.modules())
    per_cond = 8 * (depth - 1) + 5 + 2      # blocks, last block, context embedder, final linear
    per_uncond = 4 * depth + 1              # x blocks only, final linear
    if n_q8 != per_cond:
        raise RuntimeError(f"{n_q8} quantized linears, expected {per_cond}")
    if not torch.equal(pipe.encoding(ref["images"]), ids):
        raise RuntimeError("the int8 pipeline's encoder does not hold the same seeded weights")

    reset_counts()
    (img2, lat2), t_dec = timed(lambda: pipe.decoding(
        ids[:2], noise=noise2, cfg_scale=1.0, return_latents=True))
    c1 = counts()
    (img1, lat1), t_cfg = timed(lambda: pipe.decoding(
        ids[:1], noise=noise1, cfg_scale=2.0, return_latents=True))
    c2 = counts()
    # counts accumulate over both calls: cfg 2.0 adds a cond and an uncond pass per step
    expect = [(0, depth * steps, per_cond * steps, 0, 0, 0),
              (0, 3 * depth * steps, (2 * per_cond + per_uncond) * steps, 0, 0, 0)]
    if [c1, c2] != expect or (c1[2], c2[2] - c1[2]) != (9550, 14400):
        raise RuntimeError(f"int8 launch counts {[c1, c2]} differ from the path's {expect}")
    check_images(img2, 2)
    check_images(img1, 1)

    before = counts()
    _, lat2_p = pipe.decoding(ids[:2], noise=noise2, cfg_scale=1.0, kernels="plain",
                              return_latents=True)
    _, lat1_p = pipe.decoding(ids[:1], noise=noise1, cfg_scale=2.0, kernels="plain",
                              return_latents=True)
    torch.cuda.synchronize()
    if counts() != before:
        raise RuntimeError("kernels='plain' launched a kernel")
    if not (torch.isfinite(lat2).all() and torch.isfinite(lat1).all()):
        raise RuntimeError("non-finite int8 latents")
    e2 = (lat2 - lat2_p).abs().max().item()
    e1 = (lat1 - lat1_p).abs().max().item()
    log(f"  int8 kernels vs forced plain: latents max abs diff {e2:.4g} (cfg 1.0) "
        f"{e1:.4g} (cfg 2.0), latent abs max {lat2.abs().max().item():.3g}")
    if e2 > LATENT_TOL or e1 > LATENT_TOL:
        raise RuntimeError(f"int8 latents differ from the plain path by {max(e1, e2)} > {LATENT_TOL}")
    # random weights: the deviation from bf16 is printed, not held to a limit
    log(f"  int8 vs bf16 decode (random weights, no limit): latents max abs diff "
        f"{(lat2 - ref['lat2']).abs().max().item():.4g} (cfg 1.0) "
        f"{(lat1 - ref['lat1']).abs().max().item():.4g} (cfg 2.0); image PSNR "
        f"{psnr(img2, ref['img2']):.2f} dB (cfg 1.0) {psnr(img1, ref['img1']):.2f} dB (cfg 2.0)")

    w_dec = warm(lambda: pipe.decoding(ids[:2], noise=noise2, cfg_scale=1.0), 2)
    w_cfg = warm(lambda: pipe.decoding(ids[:1], noise=noise1, cfg_scale=2.0), 1)
    log(f"decode int8, 50 steps, cfg 1.0: {w_dec / 2:.3f} s/image (batch 2, {w_dec:.3f} s warm, "
        f"{t_dec:.3f} s first call) on {card}")
    log(f"decode int8, 50 steps, cfg 2.0: {w_cfg:.3f} s/image (batch 1, warm; "
        f"{t_cfg:.3f} s first call) on {card}")
    if do_profile:
        profile_decode(pipe, ids[:2], noise2, w_dec, "int8")
    del pipe
    release()
    return c2


def renderer_path(card, ref):
    """The one-step renderer at batch 8, in bf16 and in int8."""
    from selftoktokenizer_tpu_torch.core.config import FLAGSHIP_RENDERER_CONFIG

    ids = ref["ids"]
    total = (0, 0, 0, 0, 0, 0)
    images = {}
    for dtype in (torch.bfloat16, "int8"):
        pipe = build_pipeline(FLAGSHIP_RENDERER_CONFIG, dtype)
        check_decoder_widths(pipe, renderer=True)
        depth = pipe.tcfg.decoder.depth
        if tuple(pipe.model.mask_token.shape) != (1, 1, 1536) \
                or tuple(pipe.model.positional_embedding.shape) != (256, 1536):
            raise RuntimeError("not the flagship renderer's mask token and grid")
        pipe.decoding_with_renderer(ids[:1])          # warm-up outside the counted run
        reset_counts()
        (img, lat), t_first = timed(lambda: pipe.decoding_with_renderer(ids, return_latents=True))
        c = counts()
        expect = (0, 2 * depth, (8 * (depth - 1) + 7) if dtype == "int8" else 0, 0, 0, 0)
        if c != expect or c[1] != 48 or c[2] not in (0, 191):
            raise RuntimeError(f"renderer {dtype} launch counts {c} differ from {expect}")
        total = tuple(a + b for a, b in zip(total, c))
        check_images(img, 8)
        before = counts()
        _, lat_p = pipe.decoding_with_renderer(ids, kernels="plain", return_latents=True)
        torch.cuda.synchronize()
        if counts() != before:
            raise RuntimeError("kernels='plain' launched a kernel")
        if not torch.isfinite(lat.float()).all():
            raise RuntimeError("non-finite renderer latents")
        d = (lat.float() - lat_p.float()).abs()
        e = d.max().item()
        scale = lat_p.float().abs().max().item()
        q999 = torch.quantile(d.flatten(), 0.999).item() / scale
        log(f"  renderer {dtype} kernels vs forced plain: latents max abs diff {e:.4g} "
            f"({e / scale:.4g} of the scale, 0.999 quantile {q999:.4g}), latent abs max {scale:.3g}")
        if dtype == "int8":
            if q999 > RENDER_INT8_TOL[0] or e / scale > RENDER_INT8_TOL[1]:
                raise RuntimeError(f"renderer int8 latents differ from the plain path by "
                                   f"{q999} (0.999 quantile) / {e / scale} (max) of the scale "
                                   f"> {RENDER_INT8_TOL}")
        elif e > LATENT_TOL:
            raise RuntimeError(f"renderer {dtype} latents differ from the plain path by {e} > {LATENT_TOL}")
        w = warm(lambda: pipe.decoding_with_renderer(ids), 3)
        log(f"render {dtype}, one step: {8 / w:.2f} images/s (batch 8, {w * 1e3:.1f} ms warm, "
            f"{t_first * 1e3:.1f} ms first call) on {card}")
        images[str(dtype)] = img
        del pipe
        release()
    log(f"  renderer int8 vs bf16 (random weights, no limit): image PSNR "
        f"{psnr(images['int8'], images[str(torch.bfloat16)]):.2f} dB")
    return total


# ------------------------------------------------------------------- zoo ---

# the zoo's encoders at 256 px, batch 8: (label, named encoder, encoder_config
# overrides, K). Enc-Qformer-Uni-XL/2 cannot run concat (its image width 64
# and query width 512 cannot share one joint attention, in the JAX package
# as in the reference), so concat runs on Enc-Qformer-Uni-WXL/2 (256 / 256)
ZOO_ENCODERS = [
    ("Bi-XL/2 bidirectional", "Enc-Qformer-Bi-XL/2", {"qformer_mode": "dual"}, 512),
    ("Uni0-WL/1 zero-init", "Enc-Qformer-Uni0-WL/1", {"qformer_mode": "dual"}, 512),
    ("Uni-XL/2 attn_mask", "Enc-Qformer-Uni-XL/2", {"qformer_mode": "dual", "attn_mask": True},
     512),
    ("Uni-WXL/2 concat", "Enc-Qformer-Uni-WXL/2", {"qformer_mode": "concat"}, 512),
    ("Uni-XL/2 qformer", "Enc-Qformer-Uni-XL/2", {"qformer_mode": "qformer"}, 512),
    ("L/8 vit", "Enc-L/8", {}, 24),
    ("Uni-XL/2 K=1024", "Enc-Qformer-Uni-XL/2", {"qformer_mode": "dual"}, 1024),
]
# tokens per DiTi stage at each K: the flagship's at 512, bench.py's at 1024
K_PER_STAGE = {24: "9,9,3,2,1", 512: "192,184,72,48,16", 1024: "384,368,144,96,32"}
ZOO_REGISTERS = 4    # 4 + 512 + 256 = 772 keys: no multiple of the 64-key tile


def zoo_config(base=None, enc=None, encoder_config=None, k=None, model=None,
               decoder_config=None):
    """The flagship config (or ``base``) with the zoo's changes applied."""
    from selftoktokenizer_tpu_torch.core.config import AttrDict, FLAGSHIP_CONFIG, load_config

    cfg = load_config(base or FLAGSHIP_CONFIG).to_dict()
    p = cfg["tokenizer"]["params"]
    if enc is not None:
        p["enc"] = enc
    p["encoder_config"].update(encoder_config or {})
    if k is not None:
        p["k"] = p["quantizer_config"]["K"] = k
        p["k_per_stage"] = K_PER_STAGE[k]
    if model is not None:
        p["model"] = model
    p["decoder_config"].update(decoder_config or {})
    return AttrDict(cfg)


def latent_check(name, lat, ref, tol=LATENT_TOL):
    """lat finite, its largest difference from ref within tol of ref's
    scale. name says what the two are."""
    if not torch.isfinite(lat.float()).all():
        raise RuntimeError(f"{name}: non-finite values")
    e = (lat.float() - ref.float()).abs().max().item()
    scale = ref.float().abs().max().item()
    log(f"  {name}: max abs diff {e:.4g} ({e / scale:.4g} of the scale {scale:.3g})")
    if e > tol * scale:
        raise RuntimeError(f"{name}: differ by {e / scale} of the scale > {tol}")
    return e / scale


def zoo_encoder_path(card, label, cfg, images):
    """One zoo encoder at batch 8, 'highest' and 'default', each against
    the forced plain versions by the margin rules of the flagship encode."""
    pipe = build_pipeline(cfg, torch.bfloat16, encode_only=True)
    ec = pipe.tcfg.encoder
    B = images.shape[0]
    n_tok = ec.K * ((256 // 8 // ec.patch_size) ** 2 if ec.qformer_mode == "vit" else 1)
    serving = ec.qformer_mode == "dual"        # 'default' takes the bf16 trunk
    kernel_attn = serving and not (ec.bidirectional or ec.zero_init or ec.attn_mask)
    pipe.encoding(images[:1])                  # warm-up outside the counted run
    reset_counts()
    ids_hi, t_hi = timed(lambda: pipe.encoding(images))
    c1 = counts()
    ids_def, t_def = timed(lambda: pipe.encoding(images, precision="default"))
    c2 = counts()
    expect = [(1, 0, 0, 0, 0, 0), (2, ec.depth if kernel_attn else 0, 0, 0, 0, 0)]
    if [c1, c2] != expect:
        raise RuntimeError(f"{label}: launch counts {[c1, c2]} differ from the path's {expect}")
    for ids in (ids_hi, ids_def):
        if ids.dtype != torch.int32 or tuple(ids.shape) != (B, n_tok) \
                or int(ids.min()) < 0 or int(ids.max()) >= ec.codebook_size:
            raise RuntimeError(f"{label}: bad token ids {ids.dtype} {tuple(ids.shape)}")
    before = counts()
    ids_hi_p = pipe.encoding(images, kernels="plain")
    ids_def_p = pipe.encoding(images, precision="default", kernels="plain")
    _, margins = pipe.encoding_margins(images, kernels="plain")
    torch.cuda.synchronize()
    if counts() != before:
        raise RuntimeError("kernels='plain' launched a kernel")
    diff_hi = ids_hi != ids_hi_p
    if int((diff_hi & (margins >= VQ_MARGIN)).sum()) != 0:
        raise RuntimeError(f"{label} 'highest': kernel ids differ from plain ids outside the margin")
    # 'default' is the bf16 trunk for the dual modes, else the fp32 trunk
    # under the global TF32 settings
    m_def = DEFAULT_TIER_MARGIN if serving else HIGH_TIER_MARGIN
    diff_def = ids_def != ids_def_p
    if int((diff_def & (margins >= m_def)).sum()) != 0:
        raise RuntimeError(f"{label} 'default': kernel ids differ from plain ids outside the margin")
    agree = 1.0 - diff_def.float().mean().item()
    if agree < 0.5:
        raise RuntimeError(f"{label} 'default': only {agree:.3f} of ids agree with the plain path")
    w_hi = warm(lambda: pipe.encoding(images), 2)
    w_def = warm(lambda: pipe.encoding(images, precision="default"), 2)
    log(f"  {label}: ids {tuple(ids_hi.shape)} (N = {ids_hi.numel()} VQ rows), kernel vs plain "
        f"'highest' differing {int(diff_hi.sum())}, 'default' agreeing {agree:.4f} "
        f"(margin rule {m_def}; 'default' {'bf16' if serving else 'fp32'} trunk)")
    log(f"encode {label} 'highest': {B / w_hi:.2f} images/s (batch {B}, {w_hi * 1e3:.1f} ms warm, "
        f"{t_hi * 1e3:.1f} ms first call) on {card}")
    log(f"encode {label} 'default': {B / w_def:.2f} images/s (batch {B}, {w_def * 1e3:.1f} ms warm, "
        f"{t_def * 1e3:.1f} ms first call) on {card}")
    del pipe
    release()
    return c2


def variant_decoder_path(card, images, noise2, noise1, do_profile):
    """MMDiT_XL with qk-norm 'ln', the 'pos_t_emb' adaLN and mean pooling,
    its uncond_y read from a file: the 50-step bf16 decode at cfg 1.0 and
    2.0, one sampler step of the batched CFG trunk against the two separate
    calls, and the int8 decode at cfg 1.0."""
    import os

    from selftoktokenizer_tpu_torch.models import flow as flow_mod
    from selftoktokenizer_tpu_torch.models.mmdit import (
        mmdit_apply, mmdit_cfg_batched, mmdit_cfg_inference, mmdit_uncond_xonly)
    from selftoktokenizer_tpu_torch.ops import _build, routing

    os.makedirs(_build.BUILD_DIR, exist_ok=True)
    uy_path = os.path.join(_build.BUILD_DIR, "chip_smoke_uncond_y.pt")
    g = torch.Generator().manual_seed(11)
    torch.save(torch.randn(1536, generator=g), uy_path)
    cfg = zoo_config(decoder_config={"qk_norm": "ln", "time_adaln": "pos_t_emb",
                                     "sd3_cond_pooling": "mean", "uncond_y_file": uy_path})
    pipe = build_pipeline(cfg, torch.bfloat16)
    dcfg = pipe.tcfg.decoder
    depth, steps = dcfg.depth, 50
    if (dcfg.hidden_size, dcfg.qk_norm, dcfg.time_adaln, dcfg.sd3_cond_pooling) != \
            (1536, "ln", "pos_t_emb", "mean") or pipe.model.uncond_y is None \
            or tuple(pipe._ctx_mods.shape) != (depth - 1, 512, 1536):
        raise RuntimeError("not the variant decoder at the flagship widths")
    ids = pipe.encoding(images)

    reset_counts()
    (_, lat2), t_dec = timed(lambda: pipe.decoding(ids[:2], noise=noise2, cfg_scale=1.0,
                                                   return_latents=True))
    c1 = counts()
    (_, lat1), t_cfg = timed(lambda: pipe.decoding(ids[:1], noise=noise1, cfg_scale=2.0,
                                                   return_latents=True))
    c2 = counts()
    expect = [(0, depth * steps, 0, 0, 0, 0), (0, 3 * depth * steps, 0, 0, 0, 0)]
    if [c1, c2] != expect:
        raise RuntimeError(f"variant decode launch counts {[c1, c2]} differ from {expect}")
    before = counts()
    _, lat2_p = pipe.decoding(ids[:2], noise=noise2, cfg_scale=1.0, kernels="plain",
                              return_latents=True)
    _, lat1_p = pipe.decoding(ids[:1], noise=noise1, cfg_scale=2.0, kernels="plain",
                              return_latents=True)
    torch.cuda.synchronize()
    if counts() != before:
        raise RuntimeError("kernels='plain' launched a kernel")
    latent_check("variant decode bf16 cfg 1.0 latents, kernels vs forced plain", lat2, lat2_p)
    latent_check("variant decode bf16 cfg 2.0 latents, kernels vs forced plain", lat1, lat1_p)

    # one sampler step at cfg 2.0 of the batched CFG trunk (2B = 4 rows, the
    # uncond half's context keys all masked) against the two separate calls
    dd, mods, m = torch.bfloat16, pipe._ctx_mods.to(torch.bfloat16), pipe.model
    ehs = pipe._tokens_to_context(ids[:2])
    sub = {k: v[:1] for k, v in pipe.sched.items()}
    x, t = noise2, torch.full((2,), float(pipe.sched["scheduled_t"][0]), device="cuda")
    mask = torch.arange(512, device="cuda")[None, :] <= int(pipe.step_k[0])
    mask = mask.expand(2, 512)

    def pair(x, t, e, mask):
        return tuple(v.float() for v in mmdit_cfg_batched(m, dcfg, x.to(dd), t, e.to(dd), mask,
                                                          ctx_mods=mods))

    def cond(x, t, e, mask):
        return mmdit_apply(m, dcfg, x.to(dd), t, e.to(dd), mask=mask, ctx_mods=mods).float()

    def uncond(x, t, e, mask):
        return mmdit_uncond_xonly(m, dcfg, x.to(dd), t).float()

    def step(**kw):
        return flow_mod.p_sample_loop(kw.pop("model_fn", None), sub, x, ehs,
                                      step_k=pipe.step_k[:1], K=512, cfg_scale=2.0, **kw)

    with torch.no_grad():
        reset_counts()
        v_c, v_u = pair(x, t, ehs, mask)
        c_pair = counts()
        if c_pair != (0, depth, 0, 0, 0, 0):
            raise RuntimeError(f"mmdit_cfg_batched launch counts {c_pair} differ from "
                               f"{(0, depth, 0, 0, 0, 0)}")
        s_c = cond(x, t, ehs, mask)
        s_u = mmdit_cfg_inference(m, dcfg, x.to(dd), t, None, mask=torch.zeros_like(mask),
                                  ctx_mods=mods).float()
        with routing.kernel_route("plain"):
            p_c, p_u = pair(x, t, ehs, mask)
        # the same kernels on the same rows: equal bit for bit
        for name, got, want in (("cond, vs mmdit_apply", v_c, s_c),
                                ("uncond, vs mmdit_cfg_inference", v_u, s_u)):
            latent_check(f"mmdit_cfg_batched velocity {name}", got, want, tol=0.0)
        for name, got, want in (("cond, vs forced plain", v_c, p_c),
                                ("uncond, vs forced plain", v_u, p_u)):
            latent_check(f"mmdit_cfg_batched velocity {name}", got, want)
        x_pair = step(cfg_pair_fn=pair)
        x_two = step(model_fn=cond, uncond_fn=uncond)
        latent_check("one sampler step, cfg_pair_fn vs uncond_fn + model_fn", x_pair, x_two)
        w_pair = warm(lambda: step(cfg_pair_fn=pair), 5)
        w_two = warm(lambda: step(model_fn=cond, uncond_fn=uncond), 5)
        if do_profile:
            profile_train_step(lambda: step(cfg_pair_fn=pair), w_pair, "batched-CFG sampler")
            profile_train_step(lambda: step(model_fn=cond, uncond_fn=uncond), w_two,
                               "cond + x-only uncond sampler")
    total = tuple(a + b for a, b in zip(c2, c_pair))
    w_dec = warm(lambda: pipe.decoding(ids[:2], noise=noise2, cfg_scale=1.0), 2)
    w_cfg = warm(lambda: pipe.decoding(ids[:1], noise=noise1, cfg_scale=2.0), 1)
    log(f"decode variant bf16, 50 steps, cfg 1.0: {w_dec / 2:.3f} s/image (batch 2, "
        f"{w_dec:.3f} s warm, {t_dec:.3f} s first call) on {card}")
    log(f"decode variant bf16, 50 steps, cfg 2.0: {w_cfg:.3f} s/image (batch 1, warm; "
        f"{t_cfg:.3f} s first call) on {card}")
    log(f"sampler step at cfg 2.0, batch 2: batched CFG trunk {w_pair * 1e3:.1f} ms, "
        f"cond + x-only uncond calls {w_two * 1e3:.1f} ms (warm) on {card}")
    del pipe, m, mods
    release()

    pipe = build_pipeline(cfg, "int8")
    per_cond = 8 * (depth - 1) + 5 + 2
    ids8 = ids[:2]
    reset_counts()
    (_, lat8), t8 = timed(lambda: pipe.decoding(ids8, noise=noise2, cfg_scale=1.0,
                                                return_latents=True))
    c8 = counts()
    if c8 != (0, depth * steps, per_cond * steps, 0, 0, 0):
        raise RuntimeError(f"variant int8 launch counts {c8} differ from "
                           f"{(0, depth * steps, per_cond * steps, 0, 0, 0)}")
    before = counts()
    _, lat8_p = pipe.decoding(ids8, noise=noise2, cfg_scale=1.0, kernels="plain",
                              return_latents=True)
    torch.cuda.synchronize()
    if counts() != before:
        raise RuntimeError("kernels='plain' launched a kernel")
    latent_check("variant decode int8 cfg 1.0 latents, kernels vs forced plain", lat8, lat8_p)
    w8 = warm(lambda: pipe.decoding(ids8, noise=noise2, cfg_scale=1.0), 1)
    log(f"decode variant int8, 50 steps, cfg 1.0: {w8 / 2:.3f} s/image (batch 2, {w8:.3f} s "
        f"warm, {t8:.3f} s first call) on {card}")
    del pipe
    release()
    return tuple(a + b for a, b in zip(total, c8))


def register_decoder_path(card, images, noise1):
    """MMDiT_XL with 4 register tokens: the 50-step bf16 decode at cfg 2.0,
    whose unconditional branch is mmdit_cfg_inference (the register keys
    stay active: 4 + 512 + 256 keys). No yml sets register_length, so the
    decoder config takes it here and the tokenizer is built from it."""
    import dataclasses

    from selftoktokenizer_tpu_torch.models.tokenizer import ImageTokenizer, init_weights_

    pipe = build_pipeline(zoo_config(), torch.bfloat16, encode_only=True)
    pipe.tcfg.decoder = dataclasses.replace(pipe.tcfg.decoder, register_length=ZOO_REGISTERS)
    gen = torch.Generator(device="cuda")
    gen.manual_seed(12)
    with torch.device("cuda"):
        tok = ImageTokenizer(pipe.tcfg)
    init_weights_(tok, gen, zero_init_std=0.02)
    pipe.set_weights(tok)
    del tok
    depth, steps = pipe.tcfg.decoder.depth, 50
    if tuple(pipe.model.register.shape) != (1, ZOO_REGISTERS, 1536) \
            or tuple(pipe._ctx_mods.shape) != (depth - 1, ZOO_REGISTERS + 512, 6 * 1536):
        raise RuntimeError("not the register decoder at the flagship widths")
    ids = pipe.encoding(images[:1])
    reset_counts()
    (_, lat), t_first = timed(lambda: pipe.decoding(ids, noise=noise1, cfg_scale=2.0,
                                                    return_latents=True))
    c = counts()
    if c != (0, 2 * depth * steps, 0, 0, 0, 0):
        raise RuntimeError(f"register decode launch counts {c} differ from "
                           f"{(0, 2 * depth * steps, 0, 0, 0, 0)}")
    before = counts()
    _, lat_p = pipe.decoding(ids, noise=noise1, cfg_scale=2.0, kernels="plain",
                             return_latents=True)
    torch.cuda.synchronize()
    if counts() != before:
        raise RuntimeError("kernels='plain' launched a kernel")
    latent_check("register decode bf16 cfg 2.0 latents, kernels vs forced plain", lat, lat_p)
    w = warm(lambda: pipe.decoding(ids, noise=noise1, cfg_scale=2.0), 1)
    log(f"decode registers bf16, 50 steps, cfg 2.0: {w:.3f} s/image (batch 1, warm; "
        f"{t_first:.3f} s first call) on {card}")
    del pipe
    release()
    return c


def renderdit_path(card, images):
    """RenderDiT_XL at batch 8 in bf16: one pass of renderdit_apply (a
    fixed 16 x 16 mask-token grid, one key mask for every row: one kernel
    call a block) against the forced plain versions. Each row keeps a
    prefix of its 512 tokens, and odd rows mask the last 56 mask tokens."""
    from selftoktokenizer_tpu_torch.core.config import FLAGSHIP_RENDERER_CONFIG
    from selftoktokenizer_tpu_torch.models.mmdit import renderdit_apply
    from selftoktokenizer_tpu_torch.ops import routing

    pipe = build_pipeline(zoo_config(FLAGSHIP_RENDERER_CONFIG, model="RenderDiT_XL"),
                          torch.bfloat16)
    check_decoder_widths(pipe, renderer=True)
    dcfg, depth = pipe.tcfg.decoder, pipe.tcfg.decoder.depth
    ctx = pipe._tokens_to_context(pipe.encoding(images))
    B = ctx.shape[0]
    gen = torch.Generator(device="cuda")
    gen.manual_seed(13)
    active = torch.randint(1, dcfg.K + 1, (B,), generator=gen, device="cuda")
    mask = torch.arange(dcfg.K, device="cuda")[None, :] < active[:, None]
    x_mask = torch.ones((B, 256), dtype=torch.bool, device="cuda")
    x_mask[1::2, 200:] = False

    @torch.no_grad()
    def render(route="cuda", mask=mask):
        with routing.kernel_route(route):
            return renderdit_apply(pipe.model, dcfg, ctx, mask=mask, x_mask=x_mask,
                                   ctx_mods=pipe._ctx_mods)

    render()                                   # warm-up outside the counted run
    reset_counts()
    lat, t_first = timed(render)
    c = counts()
    if c != (0, depth, 0, 0, 0, 0):
        raise RuntimeError(f"RenderDiT launch counts {c} differ from {(0, depth, 0, 0, 0, 0)}")
    if tuple(lat.shape) != (8, 32, 32, 16):
        raise RuntimeError(f"RenderDiT latents {tuple(lat.shape)}")
    before = counts()
    lat_p = render("plain")
    torch.cuda.synchronize()
    if counts() != before:
        raise RuntimeError("kernels='plain' launched a kernel")
    latent_check("RenderDiT bf16 latents, kernels vs forced plain", lat, lat_p)
    # the masks reach the output: every key active gives other latents
    lat_full = render(mask=None)
    if (lat_full.float() - lat.float()).abs().max().item() == 0:
        raise RuntimeError("RenderDiT latents do not depend on the token mask")
    w = warm(render, 3)
    log(f"render RenderDiT_XL bf16, one pass: {8 / w:.2f} images/s (batch 8, {w * 1e3:.1f} ms "
        f"warm, {t_first * 1e3:.1f} ms first call) on {card}")
    del pipe, ctx
    release()
    return c


def zoo_phase(card, do_profile=False):
    """The rest of the model zoo at full width on seeded non-zero weights:
    each path's counts set to 0 just before it and read just after."""
    gen = torch.Generator(device="cuda")
    gen.manual_seed(17)
    images = torch.rand((8, 256, 256, 3), generator=gen, device="cuda") * 2 - 1
    noise2 = torch.randn((2, 32, 32, 16), generator=gen, device="cuda")
    noise1 = noise2[:1].clone()
    by_path = {}
    for label, enc, ec, k in ZOO_ENCODERS:
        t0 = time.time()
        by_path[f"zoo encode {label}"] = zoo_encoder_path(
            card, label, zoo_config(enc=enc, encoder_config=ec, k=k), images)
        log(f"  zoo encoder {label}: {time.time() - t0:.1f} s")
    t0 = time.time()
    by_path["zoo variant decoder (ln, pos_t_emb, mean pooling)"] = variant_decoder_path(
        card, images, noise2, noise1, do_profile)
    log(f"  zoo variant decoder: {time.time() - t0:.1f} s")
    t0 = time.time()
    by_path["zoo register decoder"] = register_decoder_path(card, images, noise1)
    log(f"  zoo register decoder: {time.time() - t0:.1f} s")
    t0 = time.time()
    by_path["zoo RenderDiT_XL"] = renderdit_path(card, images)
    log(f"  zoo RenderDiT_XL: {time.time() - t0:.1f} s")
    return by_path


# -------------------------------------------------------------- families ---

FAMILIES_B = {"multires_encoder": 8, "multires_mmdit": 2, "multi_tokenizer": 4, "dit_train": 8}
# the multi-resolution MMDiT's bf16 forward against its fp32 forward, relative
# to the fp32 velocity's scale: the bound of the decodes' bf16 paths
MULTIRES_BF16_TOL = 5e-2


def _flagship_params(**changes):
    from selftoktokenizer_tpu_torch.core.config import FLAGSHIP_CONFIG, load_config

    p = load_config(FLAGSHIP_CONFIG).to_dict()["tokenizer"]["params"]
    p.update(changes)
    return p


def _seeded_module(module, seed):
    from selftoktokenizer_tpu_torch.models.tokenizer import init_weights_

    gen = torch.Generator(device="cuda")
    gen.manual_seed(seed)
    init_weights_(module, gen, zero_init_std=0.02)
    return module


def _n_params(m):
    return sum(p.numel() for p in m.parameters())


def multires_encoder_path(card):
    """Enc-Qformer-Multi-Res-Uni-XL/2 at 256 px (32 x 32 x 16 latents),
    batch 8, fp32: K = 512 and low_res_K = 512, seeded token embeddings;
    its ids against the forced plain run by the 1e-6 margin rule."""
    from selftoktokenizer_tpu_torch.models import encoder as enc_mod
    from selftoktokenizer_tpu_torch.models import vq as vq_mod
    from selftoktokenizer_tpu_torch.models.tokenizer import tokenizer_config_from_params
    from selftoktokenizer_tpu_torch.ops import routing

    tcfg = tokenizer_config_from_params(_flagship_params(enc="Enc-Qformer-Multi-Res-Uni-XL/2"))
    ec = tcfg.encoder
    if (ec.depth, ec.query_dim, ec.K, ec.low_res_K, ec.codebook_size) != (16, 512, 512, 512, 32768):
        raise RuntimeError("not the multi-resolution encoder's widths")
    torch.cuda.reset_peak_memory_stats()
    with torch.device("cuda"):
        enc = _seeded_module(enc_mod.QformerEncoderMultiRes(ec), 21).requires_grad_(False)
    gen = torch.Generator(device="cuda")
    gen.manual_seed(22)
    B = FAMILIES_B["multires_encoder"]
    x = torch.randn((B, 32, 32, 16), generator=gen, device="cuda")
    te = torch.randn((B, ec.low_res_K, ec.low_res_code_dim), generator=gen, device="cuda")
    d = torch.full((B,), ec.K - 1, dtype=torch.int32, device="cuda")

    def run():
        return enc_mod.multires_encoder_apply(enc, ec, x, te, d=d)

    reset_counts()
    out, t_first = timed(run)
    c = counts()
    if c != (1, 0, 0, 0, 0, 0):
        raise RuntimeError(f"multires encoder launch counts {c}, expected (1, 0, 0, 0, 0, 0)")
    ids, outs = out[-1], out[1]
    before = counts()
    with routing.kernel_route("plain"):
        ids_p = run()[-1]
    torch.cuda.synchronize()
    if counts() != before:
        raise RuntimeError("kernels='plain' launched a kernel")
    margins = vq_mod.vq_margins(enc.quantizer, outs)[1]
    if ids.dtype != torch.int32 or tuple(ids.shape) != (B, ec.K) or int(ids.min()) < 0 \
            or int(ids.max()) >= ec.codebook_size or not torch.isfinite(out[0]).all():
        raise RuntimeError(f"multires encoder: bad ids {ids.dtype} {tuple(ids.shape)}")
    diff = ids != ids_p
    if int((diff & (margins >= VQ_MARGIN)).sum()) != 0:
        raise RuntimeError("multires encoder: kernel ids differ from plain ids outside the margin")
    w = warm(run, 3)
    log(f"  multires encoder: {_n_params(enc) / 1e6:.1f} M parameters, ids {tuple(ids.shape)} "
        f"(N = {ids.numel()} VQ rows), kernel vs plain differing {int(diff.sum())} (smallest "
        f"margin {margins.min().item():.3g}), peak {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    log(f"encode multires Uni-XL/2 fp32: {B / w:.2f} images/s (batch {B}, {w * 1e3:.1f} ms warm, "
        f"{t_first * 1e3:.1f} ms first call) on {card}")
    del enc, out, outs
    release()
    return c


def multires_mmdit_path(card):
    """The multi-resolution MMDiT at MMDiT_XL widths (depth 24, hidden 1536,
    with the low-res and rec blocks): a 256 px x (32 x 32), a 128 px low-res
    latent (16 x 16, 64 rec tokens), K = K_low = 512, token and low-res
    masks with keys off, context_see_xt and context_see_rec; fp32 then bf16
    forwards at batch 2, the bf16 velocity within MULTIRES_BF16_TOL of the
    fp32 one's scale. Plain sdpa under the full mask: no kernel."""
    from selftoktokenizer_tpu_torch.models import mmdit as mm
    from selftoktokenizer_tpu_torch.models.tokenizer import tokenizer_config_from_params

    cfg = tokenizer_config_from_params(_flagship_params()).decoder
    torch.cuda.reset_peak_memory_stats()
    t0 = time.time()
    with torch.device("cuda"):
        model = _seeded_module(mm.MMDiT(cfg, multires=True), 23).requires_grad_(False)
    n = _n_params(model)
    if (cfg.depth, cfg.hidden_size, cfg.num_heads, cfg.K) != (24, 1536, 24, 512):
        raise RuntimeError("not the MMDiT_XL widths")
    log(f"  multires MMDiT_XL: {n / 1e9:.3f} B parameters, built in {time.time() - t0:.1f} s")
    gen = torch.Generator(device="cuda")
    gen.manual_seed(24)
    B = FAMILIES_B["multires_mmdit"]
    x = torch.randn((B, 32, 32, 16), generator=gen, device="cuda")
    low = torch.randn((B, 16, 16, 16), generator=gen, device="cuda")
    ehs = torch.randn((B, 512, 16), generator=gen, device="cuda")
    ehs_low = torch.randn((B, 512, 16), generator=gen, device="cuda")
    t = torch.tensor([0.3, 0.8], device="cuda")
    pos = torch.arange(512, device="cuda")[None]
    mask = pos < torch.tensor([[200], [512]], device="cuda")
    cl_mask = pos < torch.tensor([[100], [450]], device="cuda")

    def run(dtype):
        return mm.mmdit_multires_apply(model, cfg, x.to(dtype), t, ehs, ehs_low, low.to(dtype),
                                       mask=mask, context_lowres_mask=cl_mask,
                                       context_see_xt=True, context_see_rec=True)

    reset_counts()
    v32, t32_first = timed(lambda: run(torch.float32))
    w32 = warm(lambda: run(torch.float32), 2)
    peak32 = torch.cuda.max_memory_allocated()
    model.to(torch.bfloat16)
    torch.cuda.reset_peak_memory_stats()
    v16, t16_first = timed(lambda: run(torch.bfloat16))
    w16 = warm(lambda: run(torch.bfloat16), 2)
    peak16 = torch.cuda.max_memory_allocated()
    c = counts()
    if c != (0, 0, 0, 0, 0, 0):
        raise RuntimeError(f"multires MMDiT launch counts {c}: its attention is plain sdpa")
    if tuple(v32.shape) != (B, 32, 32, 16) or v16.dtype != torch.bfloat16:
        raise RuntimeError(f"multires MMDiT: bad output {tuple(v32.shape)} {v16.dtype}")
    if not torch.isfinite(v32).all():
        raise RuntimeError("multires MMDiT: non-finite fp32 velocity")
    rel = latent_check("multires MMDiT bf16 velocity vs fp32", v16, v32, tol=MULTIRES_BF16_TOL)
    log(f"forward multires MMDiT_XL (Lq 1280, Lk 1344): fp32 {w32 * 1e3:.1f} ms warm "
        f"({t32_first * 1e3:.1f} first, peak {peak32 / 2**30:.2f} GiB), bf16 {w16 * 1e3:.1f} ms "
        f"warm ({t16_first * 1e3:.1f} first, peak {peak16 / 2**30:.2f} GiB), bf16 vs fp32 "
        f"{rel:.4g} of the scale, batch {B} on {card}")
    del model, v32, v16
    release()
    return c


def multi_tokenizer_path(card):
    """multi_tokenizer_loss with two Enc-Qformer-Uni-XL/2 encoders, at 256
    px (32 x 32) and 512 px (64 x 64), feeding MMDiT_XL at K = 2 x 512,
    fp32, with VQ states; loss and gradients held against the same call
    with the plain versions forced (the train steps' rule). One attention
    launch per joint block."""
    from selftoktokenizer_tpu_torch.models import vq as vq_mod
    from selftoktokenizer_tpu_torch.models.tokenizer import (
        MultiImageTokenizer, MultiTokenizerConfig, multi_tokenizer_loss,
        tokenizer_config_from_params)
    from selftoktokenizer_tpu_torch.models.zoo import build_decoder_config
    from selftoktokenizer_tpu_torch.ops import routing

    p = _flagship_params()
    t256 = tokenizer_config_from_params(p)
    t512 = tokenizer_config_from_params(dict(p, image_size=512))
    dec = build_decoder_config("MMDiT_XL", K=1024, input_size=32, encoder_hidden_size=16,
                               in_channels=16, decoder_config=p["decoder_config"],
                               diti_positions=True)
    cfg = MultiTokenizerConfig(
        encoders={"res256": t256.encoder, "res512": t512.encoder}, decoder=dec, k=512,
        stages=t256.stages, k_per_stage=t256.k_per_stage, image_size=256,
        train_encoder_res="res256", diffusion=t256.diffusion, quantizer=t256.quantizer)
    torch.cuda.reset_peak_memory_stats()
    with torch.device("cuda"):
        tok = _seeded_module(MultiImageTokenizer(cfg), 25)
    log(f"  multi-resolution tokenizer: {_n_params(tok) / 1e9:.3f} B parameters (MMDiT_XL at "
        f"K = {dec.K}, encoders at {t256.encoder.input_size} and {t512.encoder.input_size} latents)")
    gen = torch.Generator(device="cuda")
    gen.manual_seed(26)
    B = FAMILIES_B["multi_tokenizer"]
    batch = {"res256": torch.randn((B, 32, 32, 16), generator=gen, device="cuda"),
             "res512": torch.randn((B, 64, 64, 16), generator=gen, device="cuda")}
    C = t256.encoder.codebook_size
    draws = {"t": torch.rand((B,), generator=gen, device="cuda"),
             "noise": torch.randn(batch["res256"].shape, generator=gen, device="cuda"),
             "vq_draws": {r: {"kmeans_idx": vq_mod.kmeans_init_indices(B * 512, C, gen),
                              "react_uniforms": torch.rand((C,), generator=gen, device="cuda")}
                          for r in cfg.encoders}}
    states = {r: vq_mod.vq_state_init(tok.encoder[r].quantizer, 512) for r in cfg.encoders}

    def step():
        tok.zero_grad(set_to_none=True)
        loss, aux = multi_tokenizer_loss(tok, cfg, batch, vq_states=states, **draws)
        loss.backward()
        return float(loss.detach()), aux

    before = counts()
    with routing.kernel_route("plain"):
        loss_p, _ = step()
    torch.cuda.synchronize()
    if counts() != before:
        raise RuntimeError("kernels='plain' launched a kernel")
    named = [(n, q) for n, q in tok.named_parameters() if q.grad is not None]
    plain = [q.grad.detach().to("cpu", copy=True) for _, q in named]
    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    (loss, aux), t_first = timed(step)
    c = counts()
    peak = torch.cuda.max_memory_allocated()
    want = (0, dec.depth, 0, 0, dec.depth, dec.depth)
    if c != want:
        raise RuntimeError(f"multi-tokenizer loss launch counts {c}, expected {want}")
    hold_loss("multi-tokenizer loss", loss, loss_p)
    hold_grads("multi-tokenizer loss", named, plain)
    for r, st in aux["vq_states"].items():
        if st is None or not bool(st.initted) or not torch.isfinite(st.embed).all():
            raise RuntimeError(f"multi-tokenizer loss: the {r} quantizer did not train")
    del plain
    w = warm(step, 2)
    log(f"train multi-resolution tokenizer loss + backward, batch {B}, fp32 (TF32 off): "
        f"{w:.3f} s warm ({t_first:.3f} s counted call), loss {loss:.6f} vs plain {loss_p:.6f}, "
        f"peak {peak / 2**30:.2f} GiB on {card}")
    del tok, named, aux, states
    release()
    return c


def dit_ddpm_path(card):
    """DiT-XL/2 on 32 x 32 x 4 latents, 1000 classes, learned sigma: DDPM
    training_losses with its VB term, forward and backward at batch 8 in
    fp32; p_sample_loop over create_diffusion("250") and ddim_sample_loop
    over "ddim50", both through dit_forward_with_cfg at cfg 4.0, 2 images
    (4 rows). The same generator gives the same samples."""
    from selftoktokenizer_tpu_torch.models import ddpm
    from selftoktokenizer_tpu_torch.models import dit as dit_mod

    cfg = dit_mod.DiTConfig(**dit_mod.DIT_CONFIGS["DiT-XL/2"], input_size=32, in_channels=4,
                            num_classes=1000, learn_sigma=True)
    torch.cuda.reset_peak_memory_stats()
    with torch.device("cuda"):
        model = _seeded_module(dit_mod.DiT(cfg), 27)
    log(f"  DiT-XL/2: {_n_params(model) / 1e6:.1f} M parameters, head dim "
        f"{cfg.hidden_size // cfg.num_heads}")
    gen = torch.Generator(device="cuda")
    gen.manual_seed(28)
    B = FAMILIES_B["dit_train"]
    x0 = torch.randn((B, 32, 32, 4), generator=gen, device="cuda").clamp_(-1, 1)
    y = torch.randint(0, 1000, (B,), generator=gen, device="cuda")
    ts = torch.randint(0, 1000, (B,), generator=gen, device="cuda")
    noise = torch.randn(x0.shape, generator=gen, device="cuda")
    diffusion = ddpm.create_diffusion("")
    reset_counts()

    def train():
        model.zero_grad(set_to_none=True)
        terms = diffusion.training_losses(lambda x, t: dit_mod.dit_apply(model, cfg, x, t, y),
                                          x0, ts, noise=noise)
        loss = terms["loss"].mean()
        loss.backward()
        return terms

    terms, t_first = timed(train)
    if not all(torch.isfinite(terms[n]).all() for n in ("loss", "mse", "vb")):
        raise RuntimeError("DiT training losses: non-finite terms")
    if not all(torch.isfinite(q.grad).all() for q in model.parameters() if q.grad is not None):
        raise RuntimeError("DiT training losses: non-finite gradients")
    w_train = warm(train, 3)
    peak = torch.cuda.max_memory_allocated()
    log(f"train DiT-XL/2 DDPM loss (MSE + VB) + backward, batch {B}, fp32 (TF32 off): "
        f"{w_train:.3f} s warm ({t_first:.3f} s first), loss "
        f"{float(terms['loss'].detach().mean()):.5f}, vb {float(terms['vb'].detach().mean()):.5f} "
        f"bits/dim, peak {peak / 2**30:.2f} GiB on {card}")
    model.requires_grad_(False)
    model.zero_grad(set_to_none=True)
    labels = torch.tensor([207, 360, 1000, 1000], device="cuda")     # 2 classes, then null

    def cfg_model(x, t):
        return dit_mod.dit_forward_with_cfg(model, cfg, x, t, labels, 4.0)

    def sample(loop, spec, seed):
        d = ddpm.create_diffusion(spec)
        g = torch.Generator(device="cuda")
        g.manual_seed(seed)
        z = torch.randn((2, 32, 32, 4), generator=g, device="cuda")
        z = torch.cat([z, z])
        with torch.no_grad():
            return getattr(d, loop)(cfg_model, z.shape, rng=g, noise=z, clip_denoised=False)

    out = {}
    for loop, spec in (("p_sample_loop", "250"), ("ddim_sample_loop", "ddim50")):
        s1, t1 = timed(lambda: sample(loop, spec, 29))
        s2 = sample(loop, spec, 29)
        if tuple(s1.shape) != (4, 32, 32, 4) or not torch.isfinite(s1).all():
            raise RuntimeError(f"DiT {loop}: bad samples")
        if not torch.equal(s1, s2):
            raise RuntimeError(f"DiT {loop}: the same generator gave other samples")
        # the guidance covers the first 3 channels only (the reference's
        # quirk), and both halves' model input is the first half: DDIM's
        # first 3 channels stay equal across the halves; the ancestral step
        # also reads each half's own variance and noise
        if loop == "ddim_sample_loop" and not torch.equal(s1[:2, ..., :3], s1[2:, ..., :3]):
            raise RuntimeError(f"DiT {loop}: the guided channels differ between the halves")
        out[loop] = t1
        log(f"sample DiT-XL/2 {loop} ({spec}), cfg 4.0, 2 images (4 rows), fp32: {t1:.3f} s "
            f"({t1 / int(spec.replace('ddim', '')) * 1e3:.1f} ms a step) on {card}")
    c = counts()
    if c != (0, 0, 0, 0, 0, 0):
        raise RuntimeError(f"DiT launch counts {c}: its attention (head dim 72) is plain")
    del model
    release()
    return c


def text_encoders_path(card):
    """CLIP-L, CLIP-G and the T5-XXL encoder at the SD3 widths in fp32,
    batch 2 x 77 seeded ids; CLIP at the penultimate layer, pooled at the
    end token. Each model is freed before the next."""
    from selftoktokenizer_tpu_torch.models import text_encoders as te

    gen = torch.Generator(device="cuda")
    gen.manual_seed(30)
    specs = [
        ("CLIP-L", te.CLIPTextConfig(), lambda m, c: te.SDClipModel(m, c, layer="hidden",
                                                                     layer_idx=-2)),
        ("CLIP-G", te.CLIPTextConfig(num_hidden_layers=32, hidden_size=1280,
                                     num_attention_heads=20, intermediate_size=5120,
                                     hidden_act="gelu"), te.sdxl_clip_g),
        ("T5-XXL", te.T5Config(), te.t5xxl_model),
    ]
    reset_counts()
    for name, c, wrap in specs:
        torch.cuda.reset_peak_memory_stats()
        t0 = time.time()
        with torch.device("cuda"):
            model = _seeded_module(te.T5(c) if name == "T5-XXL" else te.CLIPTextModel(c), 31)
        model.requires_grad_(False)
        built = time.time() - t0
        if name == "T5-XXL":
            ids = torch.randint(2, c.vocab_size, (2, 77), generator=gen, device="cuda")
        else:
            ids = torch.randint(1, 49406, (2, 77), generator=gen, device="cuda")
            ids[:, 0] = 49406
            ids[0, 9:], ids[1, 30:] = 49407, 49407     # the end token, padded with itself
        enc = wrap(model, c)
        (z, pooled), t_first = timed(lambda: enc(ids))
        width = c.d_model if name == "T5-XXL" else c.hidden_size
        if tuple(z.shape) != (2, 77, width) or not torch.isfinite(z).all() or (
                pooled is not None and not torch.isfinite(pooled).all()):
            raise RuntimeError(f"{name}: bad output {tuple(z.shape)}")
        if name != "T5-XXL" and pooled is None:
            raise RuntimeError(f"{name}: no pooled output")
        w = warm(lambda: enc(ids), 3)
        log(f"encode text {name} ({_n_params(model) / 1e9:.3f} B parameters, built in "
            f"{built:.1f} s), batch 2 x 77, fp32: {w * 1e3:.1f} ms warm ({t_first * 1e3:.1f} ms "
            f"first), peak {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB on {card}")
        del model, enc, z, pooled
        release()
    c = counts()
    if c != (0, 0, 0, 0, 0, 0):
        raise RuntimeError(f"text encoder launch counts {c}: their attention is plain")
    return c


def families_phase(card, do_profile=False):
    """The sixth slice's models at full width, fp32 with TF32 off (the
    global flags come back afterwards): each path's counts set to 0 just
    before it and read just after."""
    prev = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
    by_path = {}
    try:
        for label, fn in (("families multires encoder", multires_encoder_path),
                          ("families multires MMDiT", multires_mmdit_path),
                          ("families multi-resolution tokenizer loss", multi_tokenizer_path),
                          ("families DiT + DDPM", dit_ddpm_path),
                          ("families text encoders", text_encoders_path)):
            t0 = time.time()
            by_path[label] = fn(card)
            log(f"  {label}: {time.time() - t0:.1f} s")
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = prev
    return by_path


# ---------------------------------------------------------------- corpus ---

CORPUS_N = 64
CORPUS_BATCH = 32
# (width, height): landscape, portrait, square, odd sizes, downscales of 2.5x
CORPUS_SIZES = [(300, 200), (512, 384), (256, 256), (200, 300), (384, 512), (640, 480),
                (257, 255), (333, 222)]
# card Inception features and LPIPS against the same module on the CPU, as a
# fraction of the CPU result's largest value: TF32 leaking in would put them
# near 1e-3 of their scale per layer, exact fp32 lies near 1e-6
EVAL_CPU_TOL = 1e-3
EVAL_RENDER = (16, 8)       # (images, batch) through the bf16 renderer
EVAL_DECODE = (4, 2)        # (images, batch) through the 50-step bf16 decode


def write_png(path, arr, palette=None):
    """A PNG from uint8 HxW (gray; palette indices with ``palette`` [n, 3]),
    HxWx3 (RGB) or HxWx4 (RGBA), with the standard library only."""
    import struct
    import zlib

    h, w = arr.shape[:2]
    ctype = 3 if palette is not None else {2: 0, 3: 2}.get(arr.ndim, 0)
    if arr.ndim == 3 and arr.shape[2] == 4:
        ctype = 6

    def chunk(kind, data):
        return (struct.pack(">I", len(data)) + kind + data
                + struct.pack(">I", zlib.crc32(kind + data) & 0xFFFFFFFF))

    raw = b"".join(b"\x00" + arr[y].tobytes() for y in range(h))
    png = b"\x89PNG\r\n\x1a\n" + chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, ctype, 0, 0, 0))
    if palette is not None:
        png += chunk(b"PLTE", palette.astype("uint8").tobytes())
    png += chunk(b"IDAT", zlib.compress(raw, 6)) + chunk(b"IEND", b"")
    with open(path, "wb") as f:
        f.write(png)


def png_size(path):
    import struct

    with open(path, "rb") as f:
        head = f.read(24)
    if head[:8] != b"\x89PNG\r\n\x1a\n":
        raise RuntimeError(f"{path} is no PNG")
    return struct.unpack(">II", head[16:24])


def corpus_pattern(rng, h, w):
    """uint8 [h, w, 3]: blocks of 32 pixels with noise on top (something a
    JPEG coder and a resize have to work on)."""
    import numpy as np

    g = rng.integers(0, 256, (h // 32 + 2, w // 32 + 2, 3)).astype(np.float32)
    img = np.kron(g, np.ones((32, 32, 1), np.float32))[:h, :w] + rng.normal(0, 12, (h, w, 3))
    return np.clip(img, 0, 255).astype(np.uint8)


def corpus_loader():
    """(loader, reason), decided from what is installed before anything runs."""
    import importlib.util

    from selftoktokenizer_tpu_torch.data import native

    if native.native_available():
        return "native", "a C++ compiler finds jpeglib.h and png.h"
    if importlib.util.find_spec("PIL") is not None:
        return "pil", "no C++ compiler with jpeglib.h and png.h; PIL is installed"
    return "arrays", "neither the libjpeg / libpng headers nor PIL is installed"


def make_corpus(root, loader):
    """64 images of mixed sizes and modes under root/imgs (PNG from the
    standard library's writer: RGB, grayscale, RGBA, palette; JPEG through
    PIL when it is there) and two tar shards of them under root/shards.
    Returns (sorted image paths, shard dir)."""
    import os
    import tarfile

    import numpy as np

    rng = np.random.default_rng(11)
    img_dir, shard_dir = os.path.join(root, "imgs"), os.path.join(root, "shards")
    os.makedirs(img_dir)
    os.makedirs(shard_dir)
    kinds = ["rgb", "gray", "rgba", "palette"] + (["jpeg"] if loader != "arrays" else [])
    for i in range(CORPUS_N):
        w, h = CORPUS_SIZES[i % len(CORPUS_SIZES)]
        kind = kinds[i % len(kinds)]
        rgb = corpus_pattern(rng, h, w)
        p = os.path.join(img_dir, f"im{i:03d}_{kind}.{'jpg' if kind == 'jpeg' else 'png'}")
        if kind == "jpeg":
            from PIL import Image

            Image.fromarray(rgb).save(p, quality=90)
        elif kind == "gray":
            write_png(p, rgb[..., 0])
        elif kind == "rgba":
            write_png(p, np.concatenate([rgb, rng.integers(0, 256, (h, w, 1), dtype=np.uint8)], -1))
        elif kind == "palette":
            write_png(p, (rgb[..., 0] // 8).astype(np.uint8),
                      palette=rng.integers(0, 256, (32, 3), dtype=np.uint8))
        else:
            write_png(p, rgb)
    paths = sorted(os.path.join(img_dir, n) for n in os.listdir(img_dir))
    half = len(paths) // 2
    for s, chunk in enumerate((paths[:half], paths[half:])):
        with tarfile.open(os.path.join(shard_dir, f"shard-{s:04d}.tar"), "w") as tf:
            for p in chunk:
                tf.add(p, arcname=os.path.basename(p))
    return paths, shard_dir


def corpus_rows(names, loader, shard_dir):
    """The pixels of the tool's rows by the tool's own loader, in its order."""
    import os
    import tarfile

    import numpy as np

    from selftoktokenizer_tpu_torch.data import native
    from selftoktokenizer_tpu_torch.tools import common

    by_bytes = native.preprocess_bytes if loader == "native" else common.pil_bytes
    out = []
    for n in names:
        n = str(n)
        if n.startswith("shard-"):
            shard, member = n.split("/", 1)
            with tarfile.open(os.path.join(shard_dir, shard + ".tar")) as tf:
                out.append(by_bytes(tf.extractfile(member).read(), 256))
        else:
            out.append(common.load_fn(loader)(n, 256))
    return np.concatenate(out)


def corpus_tokenize_path(card, pipe, files, paths, shard_dir, loader, tmp):
    """tokenize_corpus.main over the folder and the shards at batch 32,
    'highest' and 'default', and once with --margin-stats; each row's ids
    against the pipeline's own encode of the same batches of the same
    pixels (equal)."""
    import os

    import numpy as np

    from selftoktokenizer_tpu_torch.tools import common, tokenize_corpus

    runs = [("folder", "highest", False), ("folder", "default", False),
            ("shards", "highest", False), ("folder", "highest", True)]
    lines = []
    if loader == "arrays":
        # no decoder at all: the tool's loop over arrays made in memory
        rng = np.random.default_rng(12)
        imgs = np.stack([corpus_pattern(rng, 256, 256) for _ in range(CORPUS_N)])
        imgs = imgs.astype(np.float32) / 127.5 - 1.0
        names = np.asarray([f"array{i}" for i in range(CORPUS_N)])
        batches = [(imgs[i:i + CORPUS_BATCH], names[i:i + CORPUS_BATCH])
                   for i in range(0, CORPUS_N, CORPUS_BATCH)]
        reset_counts()
        for _, prec, margins in runs:
            pipe.encode_precision = prec
            res = tokenize_corpus.tokenize(pipe, batches, margin_stats=margins)
            lines.append((res, imgs))
        pipe.encode_precision = "highest"
        c = counts()
    else:
        reset_counts()
        for i, (src, prec, margins) in enumerate(runs):
            out = os.path.join(tmp, f"tokens{i}.npz")
            argv = [*files, "--data-dir", os.path.dirname(paths[0]) if src == "folder"
                    else shard_dir, "--out", out, "--batch-size", str(CORPUS_BATCH),
                    "--encode-precision", prec] + (["--margin-stats"] if margins else [])
            line = tokenize_corpus.main(argv)
            if line["loader"] != loader or line["n"] != CORPUS_N:
                raise RuntimeError(f"tokenize_corpus {src} {prec}: {line}")
            z = np.load(out)
            res = {"tokens": z["tokens"], "paths": z["paths"],
                   "margins": z["margins"] if margins else None, "line": line}
            lines.append((res, None))
        c = counts()
    for (res, arrays), (src, prec, margins) in zip(lines, runs):
        pixels = arrays if arrays is not None else corpus_rows(res["paths"], loader, shard_dir)
        want_ids, want_m = [], []
        for i in range(0, CORPUS_N, CORPUS_BATCH):
            x = torch.from_numpy(pixels[i:i + CORPUS_BATCH]).cuda()
            if margins:
                ids, m = pipe.encoding_margins(x)
                want_m.append(m.cpu().numpy())
            else:
                ids = pipe.encoding(x, precision=prec)
            want_ids.append(ids.cpu().numpy())
        if not np.array_equal(res["tokens"], np.concatenate(want_ids)):
            raise RuntimeError(f"tokenize_corpus {src} {prec}: ids differ from the pipeline's "
                               "encode of the same rows")
        if margins and not np.array_equal(res["margins"], np.concatenate(want_m)):
            raise RuntimeError("tokenize_corpus --margin-stats: margins differ from the pipeline's")
        if arrays is None:
            line = res["line"]
            log(f"  tokenize_corpus {src} {prec}{' --margin-stats' if margins else ''}: "
                f"{line['images_per_s']} images/s over the tool's loop (its encodes "
                f"{line['encode_images_per_s']} images/s; device busy "
                f"{line['device_busy_share']} of the loop), loader {line['loader']}, ids "
                f"equal to the pipeline's encode of the same rows ({CORPUS_N} x {pipe.K})"
                + (f", margin min {line['margin_stats']['min']}" if margins else "")
                + f" on {card}")
        else:
            log(f"  tokenize loop {prec} over arrays: {res['n'] / res['wall_s']} images/s, "
                f"device busy {res['device_s'] and res['device_s'] / res['wall_s']}, ids "
                f"equal to the pipeline's encode on {card}")
    # the parts alone: the encode at batch 32 and the loader with 4 threads
    x32 = torch.from_numpy(corpus_rows(lines[0][0]["paths"][:CORPUS_BATCH], loader, shard_dir)
                           if loader != "arrays" else lines[0][1][:CORPUS_BATCH]).cuda()
    w_hi = warm(lambda: pipe.encoding(x32), 3)
    w_def = warm(lambda: pipe.encoding(x32, precision="default"), 3)
    log(f"  encode alone, batch {CORPUS_BATCH}: 'highest' {CORPUS_BATCH / w_hi:.2f} images/s "
        f"({w_hi * 1e3:.1f} ms), 'default' {CORPUS_BATCH / w_def:.2f} images/s "
        f"({w_def * 1e3:.1f} ms) on {card}")
    if loader != "arrays":
        t0 = time.time()
        n = sum(len(names) for _, names in common.file_batches(paths, 256, CORPUS_BATCH, loader))
        t = time.time() - t0
        log(f"  loader alone ({loader}{', 4 threads' if loader == 'native' else ', one thread'}): "
            f"{n / t:.2f} images/s ({n} images of {len(CORPUS_SIZES)} sizes up to 640 x 480, "
            f"{t:.2f} s) on {card}")
    return c


def corpus_eval_path(card, loader, paths):
    """eval_recon's loop with the 'random' Inception and LPIPS nets: 16
    images through the bf16 renderer at batch 8, 4 through the 50-step bf16
    decode at batch 2; its PSNR / SSIM against utils.metrics on the same
    reconstructions, LPIPS(x, x) = 0, the card's Inception and LPIPS against
    the CPU's, the TF32 flags unchanged; Inception (batch 32, 299 px) and
    LPIPS (batch 8, 256 px) timed."""
    import copy

    import numpy as np

    from selftoktokenizer_tpu_torch.core.config import FLAGSHIP_CONFIG, FLAGSHIP_RENDERER_CONFIG
    from selftoktokenizer_tpu_torch.tools import common, eval_recon
    from selftoktokenizer_tpu_torch.utils.metrics import psnr as m_psnr, ssim as m_ssim

    flags = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
    fid_net, lpips_net = eval_recon.build_eval_nets("random", "random", "cuda")
    rng = np.random.default_rng(13)

    def batches(n, b):
        if loader == "arrays":
            imgs = np.stack([corpus_pattern(rng, 256, 256) for _ in range(n)])
            imgs = imgs.astype(np.float32) / 127.5 - 1.0
            return [(imgs[i:i + b], np.arange(i, i + b)) for i in range(0, n, b)]
        return common.file_batches(paths[:n], 256, b, loader)

    total = (0, 0, 0, 0, 0, 0)
    kept = None
    for label, cfg, (n, b), renderer in (
            ("renderer bf16", FLAGSHIP_RENDERER_CONFIG, EVAL_RENDER, True),
            ("50-step decode bf16", FLAGSHIP_CONFIG, EVAL_DECODE, False)):
        pipe = build_pipeline(cfg, torch.bfloat16)
        check_decoder_widths(pipe, renderer=renderer)
        seen = []
        reset_counts()
        t0 = time.time()
        res = eval_recon.evaluate(pipe, batches(n, b), renderer=renderer, fid_net=fid_net,
                                  lpips_net=lpips_net,
                                  on_batch=lambda a, r, names: seen.append((a, r)))
        t = time.time() - t0
        c = counts()
        total = tuple(x + y for x, y in zip(total, c))
        if c[0] < 1 or c[1] < 1:
            raise RuntimeError(f"eval_recon {label}: launch counts {c}")
        if res["n"] != n or not all(math.isfinite(res[k]) for k in ("psnr", "ssim", "rfid", "lpips")):
            raise RuntimeError(f"eval_recon {label}: {res}")
        ref = torch.cat([a for a, _ in seen])
        rec = torch.cat([r for _, r in seen])
        check_images(rec, n)
        p = float(m_psnr(rec, ref).double().mean())
        s = float(m_ssim(rec, ref).double().mean())
        if abs(p - res["psnr"]) > 1e-6 * abs(p) or abs(s - res["ssim"]) > 1e-6 * max(abs(s), 1.0):
            raise RuntimeError(f"eval_recon {label}: psnr / ssim {res['psnr']} / {res['ssim']} "
                               f"differ from utils.metrics' {p} / {s}")
        log(f"  eval_recon {label}: {n} images at batch {b} in {t:.1f} s, "
            f"{res['images_per_s']:.3f} images/s after the first batch; psnr {res['psnr']:.3f} "
            f"ssim {res['ssim']:.4f} lpips {res['lpips']:.4f} rfid {res['rfid']:.4g} "
            f"(random nets: plumbing, not quality), equal to utils.metrics on the same "
            f"reconstructions; launches {c} on {card}")
        if kept is None:
            kept = (ref[:4].clone(), rec[:4].clone())
        del pipe, seen, ref, rec
        release()
    if (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32) != flags:
        raise RuntimeError("the evaluation changed the global TF32 flags")
    ref, rec = kept
    same = lpips_net(ref, ref)
    if float(same.abs().max()) != 0.0:
        raise RuntimeError(f"LPIPS of an image with itself is {same.tolist()}, not 0")
    # the card against the CPU, same weights and inputs: TF32 leaking in shows here
    with torch.no_grad():
        f_gpu, l_gpu = fid_net(rec).cpu(), lpips_net(rec, ref).cpu()
        f_cpu = copy.deepcopy(fid_net).cpu()(rec.cpu())
        l_cpu = copy.deepcopy(lpips_net).cpu()(rec.cpu(), ref.cpu())
    ef = float((f_gpu - f_cpu).abs().max() / f_cpu.abs().max())
    el = float((l_gpu - l_cpu).abs().max() / l_cpu.abs().max())
    log(f"  Inception features card vs CPU: {ef:.3g} of their scale; LPIPS {el:.3g} "
        f"(limit {EVAL_CPU_TOL}); global TF32 flags unchanged {flags}")
    if ef > EVAL_CPU_TOL or el > EVAL_CPU_TOL:
        raise RuntimeError(f"card Inception / LPIPS differ from the CPU by {ef} / {el}")
    gen = torch.Generator(device="cuda")
    gen.manual_seed(14)
    x32 = torch.rand((32, 299, 299, 3), generator=gen, device="cuda")
    a8, b8 = (torch.rand((8, 256, 256, 3), generator=gen, device="cuda") for _ in range(2))
    with torch.no_grad():
        t_inc = time_ms(lambda: fid_net(x32), warmup=2, reps=3, rounds=3, hold=False)
        t_lp = time_ms(lambda: lpips_net(a8, b8), warmup=2, reps=3, rounds=3, hold=False)
    log(f"  Inception pool3, batch 32, 299 px: {t_inc:.2f} ms; LPIPS-VGG16, batch 8, "
        f"256 px: {t_lp:.2f} ms (fp32, TF32 off) on {card}")
    return total


def corpus_smoke_path(card, paths, tmp):
    """tools/smoke.py on one image of the corpus: the flagship, 50 bf16
    steps; the PNG it writes must be 256 x 256."""
    import os

    from selftoktokenizer_tpu_torch.tools import smoke

    out = os.path.join(tmp, "smoke")
    reset_counts()
    t0 = time.time()
    written = smoke.main(["--image", paths[1], "--out-dir", out, "--zero-init-std", "0.02"])
    t = time.time() - t0
    c = counts()
    if len(written) != 1 or png_size(written[0]) != (256, 256):
        raise RuntimeError(f"smoke wrote {written}")
    if c[0] != 1 or c[1] < 1:
        raise RuntimeError(f"smoke launch counts {c}")
    log(f"  smoke: {os.path.basename(paths[1])} -> {os.path.basename(written[0])} "
        f"(256 x 256) in {t:.1f} s, the pipeline's build included; launches {c} on {card}")
    release()
    return c


def corpus_phase(card, do_profile=False):
    """The seventh slice: images in, ids and quality numbers out, through
    the tools at the flagship widths on seeded weights."""
    import os
    import shutil
    import tempfile

    from selftoktokenizer_tpu_torch.core.config import FLAGSHIP_CONFIG

    loader, reason = corpus_loader()
    log(f"  loader: {loader} ({reason})")
    tmp = tempfile.mkdtemp(prefix="chip_smoke_corpus_")
    by_path = {}
    try:
        paths, shard_dir = (make_corpus(tmp, loader) if loader != "arrays" else ([], None))
        if loader == "native":
            from selftoktokenizer_tpu_torch.data import native

            t0 = time.time()
            native.load_library()      # a failed build raises: the phase fails
            log(f"  C++ loader built in {time.time() - t0:.1f} s")
        # the flagship's encoder and VAE as the files a user passes
        pipe = build_pipeline(FLAGSHIP_CONFIG, torch.float32, encode_only=True)
        tok_pth, vae_pt = os.path.join(tmp, "encoder.pth"), os.path.join(tmp, "vae.pt")
        torch.save({"encoder." + k: v.cpu() for k, v in pipe.encoder.state_dict().items()},
                   tok_pth)
        torch.save({k: v.cpu() for k, v in pipe.vae.state_dict().items()}, vae_pt)
        files = ["--pretrained", tok_pth, "--vae-path", vae_pt]
        t0 = time.time()
        by_path["corpus tokenize_corpus"] = corpus_tokenize_path(
            card, pipe, files, paths, shard_dir, loader, tmp)
        log(f"  corpus tokenize_corpus: {time.time() - t0:.1f} s")
        del pipe
        release()
        t0 = time.time()
        by_path["corpus eval_recon"] = corpus_eval_path(card, loader, paths)
        log(f"  corpus eval_recon: {time.time() - t0:.1f} s")
        if loader == "arrays":
            log("  smoke tool: not run (it reads an image file and writes a PNG, and neither "
                "the C++ loader nor PIL is installed)")
        else:
            t0 = time.time()
            by_path["corpus smoke"] = corpus_smoke_path(card, paths, tmp)
            log(f"  corpus smoke: {time.time() - t0:.1f} s")
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    for label, c in by_path.items():
        if c[0] < 1 or c[1] < 1:
            raise RuntimeError(f"{label}: vq_argmax / attention launches {c[:2]}")
    return by_path


# --------------------------------------------------------------- drivers ---

DRIVERS_CORPUS = (40, 256)          # gen_corpus images, px
DRIVERS_HOLDOUT = 8                 # train_vae's held-out images
DRIVERS_VAE = (5, 8)                # train_vae steps, batch (bf16)
DRIVERS_BATCH = 4                   # tokenizer / renderer batch, and --eval-batch
DRIVERS_EVAL_STEPS = 8              # the tokenizer's eval decode
ROUND_TRIP_DEPTH = 2                # MMDiT_XL depth of the file round trip (width kept)
RESUME_RTOL = 1e-4                  # straight against resumed final loss (index_add_ order)


def cut_depth_config(src, dst, depth):
    """Write ``src`` with its decoder cut to ``depth`` blocks at the same
    width (decoder_config ``hidden_size``)."""
    import yaml

    with open(src) as f:
        cfg = yaml.safe_load(f)
    dc = cfg["tokenizer"]["params"].setdefault("decoder_config", {})
    dc.update(depth=depth, hidden_size=1536)
    with open(dst, "w") as f:
        yaml.safe_dump(cfg, f)
    return dst


def run_driver(card, label, fn, expect, steps=None, backward=0):
    """Run one driver with every launch count set to 0 just before it; hold
    the counts (vq_argmax, attention) to ``expect`` and the attention
    backward's to ``backward``; print its wall, peak
    memory and, for a trainer, its warm steps/s and the device's busy share
    of its loop. Returns (result, counts)."""
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    res, t = timed(fn)
    c = counts()
    if c[:2] != expect or c[2:4] != (0, 0) or c[5] != backward:
        raise RuntimeError(f"{label}: launch counts {c}, expected {expect + (0, 0)} and "
                           f"{backward} attention backward launches")
    peak = torch.cuda.max_memory_allocated() / 2**30
    timing = res.get("timing") if isinstance(res, dict) else None
    extra = ""
    if timing:
        sps, busy = timing["warm_steps_per_s"], timing["device_busy_share"]
        extra = (f", {sps:.3f} warm steps/s, device busy {busy:.3f} of the step loop "
                 f"({steps} steps)") if sps is not None else ""
    log(f"  driver {label}: {t:.1f} s wall, peak {peak:.2f} GiB{extra}; launches "
        f"vq_argmax {c[0]}, attention {c[1]} ({c[4]} fp32), attention backward {c[5]} on "
        f"{card}")
    return res, c


def summarize_metrics(path):
    """``tools/summarize_convergence.py``'s main over a metrics file: its text."""
    import contextlib
    import io

    from selftoktokenizer_tpu_torch.tools import summarize_convergence

    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        summarize_convergence.main(path)
    return buf.getvalue()


def drivers_phase(card, do_profile=False):
    """The eighth slice: the training drivers, in process through their
    ``main``, at the flagship widths: gen_corpus -> train_vae (the SD3 VAE
    at its widths, bf16) -> encode_corpus -> train_tokenizer at full depth
    (fp32, TF32 off, EMA, eval decodes and image-space eval) -> the file
    round trip at MMDiT_XL depth 2 (straight against resumed, export,
    SelftokPipeline from the export, certify_tiers, train_renderer,
    demo_e2e) -> train_renderer at full depth."""
    import os
    import shutil
    import tempfile

    import numpy as np

    from selftoktokenizer_tpu_torch.core.config import (
        FLAGSHIP_CONFIG, FLAGSHIP_RENDERER_CONFIG, load_config)
    from selftoktokenizer_tpu_torch.models.tokenizer import tokenizer_config_from_params
    from selftoktokenizer_tpu_torch.pipeline import SelftokPipeline
    from selftoktokenizer_tpu_torch.pipeline.pipeline import encode_latents
    from selftoktokenizer_tpu_torch.pipeline.preprocess import load_image
    from selftoktokenizer_tpu_torch.tools import (
        certify_tiers, convert_ckpt, demo_e2e, encode_corpus, gen_corpus, train_renderer,
        train_tokenizer, train_vae)
    from selftoktokenizer_tpu_torch.train.vae import load_vae_params

    prev = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
    tmp = tempfile.mkdtemp(prefix="chip_smoke_drivers_")
    by_path = {}
    t_phase = time.time()

    def j(*p):
        return os.path.join(tmp, *p)

    def size_gb(path):
        return os.path.getsize(path) / 1e9

    try:
        du = shutil.disk_usage(tmp)
        log(f"  temporary directory: {du.free / 1e9:.1f} GB free of {du.total / 1e9:.1f} GB")
        tcfg = tokenizer_config_from_params(dict(load_config(FLAGSHIP_CONFIG).tokenizer.params))
        check_train_widths(tcfg, renderer=False)
        rcfg = tokenizer_config_from_params(
            dict(load_config(FLAGSHIP_RENDERER_CONFIG).tokenizer.params))
        check_train_widths(rcfg, renderer=True)
        D, Denc, B, E = tcfg.decoder.depth, tcfg.encoder.depth, DRIVERS_BATCH, DRIVERS_EVAL_STEPS
        n_img, px = DRIVERS_CORPUS
        vae_steps, vae_b = DRIVERS_VAE

        # 1. the corpus
        (paths, _), c = run_driver(card, "gen_corpus", lambda: gen_corpus.main(
            ["--out", j("imgs"), "--n", str(n_img), "--size", str(px)]), (0, 0))
        by_path["drivers gen_corpus"] = c
        # 2. the VAE at its published widths, then the corpus's latents
        vres, c = run_driver(card, "train_vae", lambda: train_vae.main(
            ["--data-dir", j("imgs"), "--size", str(px), "--steps", str(vae_steps),
             "--batch-size", str(vae_b), "--ch", "128", "--ch-mult", "1,2,4,4",
             "--res-blocks", "2", "--holdout", str(DRIVERS_HOLDOUT), "--eval-batch", "8",
             "--warmup", "0", "--log-interval", "1", "--eval-interval", "1000",
             "--ckpt-interval", "0", "--ckpt-dir", j("vae"),
             "--metrics-out", j("vae.jsonl"), "--sample-out", j("vae_sample.png")]),
            (0, 0), vae_steps)
        by_path["drivers train_vae"] = c
        vlog = [json.loads(s) for s in open(j("vae.jsonl"))]
        losses = [r["loss"] for r in vlog if "loss" in r]
        if not (all(math.isfinite(v) for v in losses) and math.isfinite(vres["eval_psnr_db"])):
            raise RuntimeError(f"train_vae: losses {losses}, eval {vres}")
        log(f"  train_vae: {vres['n_params'] / 1e6:.1f} M parameters, loss "
            f"{losses[0]:.5f} -> {losses[-1]:.5f}, held-out PSNR {vres['eval_psnr_db']:.3f} dB, "
            f"SSIM {vres['eval_ssim']:.4f}; checkpoint {size_gb(j('vae', f'step_{vae_steps}')):.3f} GB")
        del vres
        meta, c = run_driver(card, "encode_corpus", lambda: encode_corpus.main(
            ["--vae-ckpt", j("vae", f"step_{vae_steps}"), "--images-dir", j("imgs"),
             "--out", j("lat.npy"), "--size", str(px), "--batch", "8"]), (0, 0))
        by_path["drivers encode_corpus"] = c
        lat = np.load(j("lat.npy"))
        if lat.shape != (n_img, px // 8, px // 8, 16) or not np.isfinite(lat).all():
            raise RuntimeError(f"encode_corpus: latents {lat.shape}")

        # 3. the tokenizer at full depth: 4 steps, evals at 0, 2 and 4 (live
        # and EMA), each an encode and an E-step decode
        lat_args = ["--latents-file", j("lat.npy"), "--data_size", str(px),
                    "--batch-size", str(B), "--log-interval", "1"]
        n_evals, tracks, steps = 3, 2, 4
        expect = (n_evals * tracks, steps * D + n_evals * tracks * E * D)
        res, c = run_driver(card, "train_tokenizer (full depth)", lambda: train_tokenizer.main(
            ["--yml-path", FLAGSHIP_CONFIG, "--steps", str(steps), "--ema-decay", "0.999",
             "--eval-interval", "2", "--eval-steps", str(E), "--eval-batch", str(B),
             "--eval-image-space", "--ckpt-interval", "0", "--ckpt-dir", j("tok_full"),
             "--metrics-out", j("tok.jsonl")] + lat_args), expect, steps, backward=steps * D)
        by_path["drivers train_tokenizer"] = c
        res["state"].release()
        del res
        recs = [json.loads(s) for s in open(j("tok.jsonl"))]
        ev = [r for r in recs if "eval_latent_mse" in r]
        if len(ev) != n_evals or "vae_ceiling_psnr_db" not in ev[0] or \
                not all(math.isfinite(r["eval_image_psnr_db_ema"]) for r in ev):
            raise RuntimeError(f"train_tokenizer evals: {ev}")
        log("  " + summarize_metrics(j("tok.jsonl")).strip().replace("\n", "\n  "))
        log(f"  VAE ceiling {ev[0]['vae_ceiling_psnr_db']:.3f} dB / "
            f"{ev[0]['vae_ceiling_ssim']:.4f}; image PSNR at step 4 "
            f"{ev[-1]['eval_image_psnr_db']:.3f} dB (EMA {ev[-1]['eval_image_psnr_db_ema']:.3f})")

        # 4. the file round trip at depth ROUND_TRIP_DEPTH, every width kept
        d = ROUND_TRIP_DEPTH
        yml = cut_depth_config(FLAGSHIP_CONFIG, j("tok-d2.yml"), d)
        ryml = cut_depth_config(FLAGSHIP_RENDERER_CONFIG, j("ren-d2.yml"), d)
        rt = lat_args + ["--yml-path", yml, "--ema-decay", "0.999"]
        straight, c1 = run_driver(card, "train_tokenizer depth 2, 4 steps straight",
                                  lambda: train_tokenizer.main(
                                      rt + ["--steps", "4", "--ckpt-interval", "0",
                                            "--ckpt-dir", j("tok_a")]), (0, 4 * d), 4,
                                   backward=4 * d)
        straight["state"].release()
        first, c2 = run_driver(card, "train_tokenizer depth 2, 2 steps + checkpoint",
                               lambda: train_tokenizer.main(
                                   rt + ["--steps", "2", "--ckpt-interval", "2",
                                         "--ckpt-dir", j("tok_b")]), (0, 2 * d), 2,
                               backward=2 * d)
        first["state"].release()
        resumed, c3 = run_driver(card, "train_tokenizer depth 2, resumed at 2 to 4",
                                 lambda: train_tokenizer.main(
                                     rt + ["--steps", "4", "--resume-from-steps", "2",
                                           "--ckpt-interval", "4", "--ckpt-dir", j("tok_b")]),
                                 (0, 2 * d), 2, backward=2 * d)
        by_path["drivers round trip: tokenizer"] = tuple(sum(x) for x in zip(c1, c2, c3))
        a, b_ = straight["final_loss"], resumed["final_loss"]
        if not (math.isfinite(a) and abs(a - b_) <= RESUME_RTOL * abs(a)):
            raise RuntimeError(f"resumed final loss {b_} differs from the straight run's {a}")
        ck = j("tok_b", "step_4")
        log(f"  round trip: final loss straight {a:.8f}, resumed {b_:.8f} (relative "
            f"{abs(a - b_) / abs(a):.3g}); train state files step_2 "
            f"{size_gb(j('tok_b', 'step_2')):.3f} GB, step_4 {size_gb(ck):.3f} GB")
        state = resumed["state"]
        tcfg2 = tokenizer_config_from_params(dict(load_config(yml).tokenizer.params))
        if (tcfg2.decoder.depth, tcfg2.decoder.hidden_size) != (d, 1536):
            raise RuntimeError(f"round-trip decoder {tcfg2.decoder}")

        (_, t_exp) = timed(lambda: convert_ckpt.main(["export", "--yml-path", yml, "--src", ck,
                                                      "--dst", j("tok.pth")]))
        (_, t_ema) = timed(lambda: convert_ckpt.main(["export", "--yml-path", yml, "--src", ck,
                                                      "--dst", j("tok_ema.pth"), "--ema"]))
        log(f"  convert_ckpt export {t_exp:.1f} s ({size_gb(j('tok.pth')):.3f} GB), --ema "
            f"{t_ema:.1f} s ({size_gb(j('tok_ema.pth')):.3f} GB)")

        # the exported .pth in the pipeline: every leaf bit-equal to the state's
        pipe = SelftokPipeline(load_config(yml), ckpt_path=j("tok.pth"), datasize=px,
                               device="cuda")
        for part, own, got in (("encoder", state.model.encoder, pipe.encoder),
                               ("model", state.model.model, pipe.model)):
            want_sd, got_sd = own.state_dict(), got.state_dict()
            if set(want_sd) != set(got_sd):
                raise RuntimeError(f"pipeline {part} keys differ from the state's: "
                                   f"{sorted(set(want_sd) ^ set(got_sd))[:5]}")
            bad = [k for k in want_sd if not torch.equal(want_sd[k], got_sd[k])]
            if bad:
                raise RuntimeError(f"pipeline {part} leaves differ from the state's: {bad[:5]}")
        vae, vcfg = load_vae_params(j("vae", f"step_{vae_steps}"))
        pipe.set_weights(vae=vae)
        held = np.concatenate([load_image(q, px) for q in paths[-B:]])
        reset_counts()
        ids_pipe = pipe.encoding(held)
        with torch.no_grad():
            x0 = pipe._images_to_latents(pipe._to_device(held))
            _, ids_state = encode_latents(state.model.encoder, tcfg2.encoder, x0, "highest")
            _, margins = encode_latents(state.model.encoder, tcfg2.encoder, x0, "highest",
                                        margins=True)
        c4 = counts()
        diff = ids_pipe != ids_state
        if int((diff & (margins >= VQ_MARGIN)).sum()) != 0 or c4[:2] != (2, 0):
            raise RuntimeError(f"pipeline encode ids differ from the state's outside the "
                               f"margin, or launches {c4}")
        log(f"  SelftokPipeline(ckpt_path=export): {len(pipe.encoder.state_dict())} encoder and "
            f"{len(pipe.model.state_dict())} decoder leaves bit-equal to the state's; ids of "
            f"{B} held-out images: {int(diff.sum())}/{diff.numel()} differ (smallest margin "
            f"{margins.min().item():.3g}); launches {c4}")
        by_path["drivers round trip: pipeline encode"] = c4
        del pipe, vae, x0
        state.release()
        del state, resumed, straight, first

        # certify_tiers: per tier, ids and margins of 3 batches of 12 and of
        # the held-out batch (one vq_argmax each; the 'default' trunk's query
        # attention 2 x Denc), and a 4-step decode of the held-out ids
        n_stat, cb, dsteps = n_img - B, 12, 4
        nb = -(-n_stat // cb) + 1
        recs, c = run_driver(card, "certify_tiers", lambda: certify_tiers.main(
            ["--ckpt", ck, "--yml-path", yml, "--latents-file", j("lat.npy"),
             "--n", str(n_stat), "--batch", str(cb), "--eval-batch", str(B),
             "--decode-steps", str(dsteps), "--out", j("tiers.jsonl")]),
            (3 * nb, nb * 2 * Denc + 3 * dsteps * d))
        by_path["drivers certify_tiers"] = c
        by_tier = {r["tier"]: r for r in recs}
        if by_tier["highest"]["flip_rate_vs_highest"] != 0.0 or \
                not all(math.isfinite(r["decode_mse"]) for r in recs):
            raise RuntimeError(f"certify_tiers records: {recs}")
        log("  certify_tiers: " + "; ".join(
            f"{r['tier']} flips {r['flip_rate_vs_highest']:.4g}, margin median "
            f"{r['margin_median']:.3g}, decode MSE {r['decode_mse']:.5f}" for r in recs))

        # the renderer from the exported .pth, 2 steps + checkpoint
        rres, c = run_driver(card, "train_renderer depth 2, from the export",
                             lambda: train_renderer.main(
                                 ["--yml-path", ryml, "--tokenizer-ckpt", j("tok.pth"),
                                  "--latents-file", j("lat.npy"), "--steps", "2",
                                  "--batch-size", str(B), "--log-interval", "1",
                                  "--ckpt-interval", "2", "--ckpt-dir", j("ren")]),
                             (2, 2 * 2 * d), 2, backward=2 * (2 * d - 1))
        by_path["drivers round trip: train_renderer"] = c
        rres["state"].release()
        del rres
        log(f"  renderer checkpoint {size_gb(j('ren', 'step_2')):.3f} GB")
        demo, c = run_driver(card, "demo_e2e", lambda: demo_e2e.main(
            ["--tokenizer-ckpt", ck, "--renderer-ckpt", j("ren", "step_2"), "--yml-path", yml,
             "--renderer-yml", ryml, "--latents-file", j("lat.npy"), "--n", str(B),
             "--decode-steps", str(E), "--out", j("demo.png"), "--json-out", j("demo.jsonl")]),
            (1, E * d + 2 * d))
        by_path["drivers round trip: demo_e2e"] = c
        if png_size(j("demo.png")) != (B * px, 4 * px) or \
                not all(math.isfinite(demo[f"{r}_psnr_db"]) for r in ("vae", "diffusion", "renderer")):
            raise RuntimeError(f"demo_e2e: {demo}, grid {png_size(j('demo.png'))}")
        log(f"  demo_e2e: PSNR / SSIM vae {demo['vae_psnr_db']} / {demo['vae_ssim']}, "
            f"diffusion {demo['diffusion_psnr_db']} / {demo['diffusion_ssim']}, renderer "
            f"{demo['renderer_psnr_db']} / {demo['renderer_ssim']}")

        # 5. the renderer at full depth: 3 steps, no checkpoint
        rres, c = run_driver(card, "train_renderer (full depth)", lambda: train_renderer.main(
            ["--yml-path", FLAGSHIP_RENDERER_CONFIG, "--tokenizer-ckpt", j("tok.pth"),
             "--latents-file", j("lat.npy"), "--steps", "3", "--batch-size", str(B),
             "--log-interval", "1", "--ckpt-interval", "0", "--ckpt-dir", j("ren_full")]),
            (3, 3 * 2 * rcfg.decoder.depth), 3, backward=3 * (2 * rcfg.decoder.depth - 1))
        by_path["drivers train_renderer"] = c
        if not math.isfinite(rres["final_recon_mse"]):
            raise RuntimeError(f"train_renderer: {rres}")
        rres["state"].release()
        del rres
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = prev
        shutil.rmtree(tmp, ignore_errors=True)
        release()
    log(f"  phase drivers: {time.time() - t_phase:.1f} s")
    return by_path


# ----------------------------------------------------------------- train ---

TRAIN_BATCH = 4
# warm steps beyond the path's own (3 tokenizer, 2 renderer steps), taken
# only so that the warm step time is a median of several: host time spreads
TIMING_REPEATS = 3


def check_train_widths(tcfg, renderer):
    enc, dec = tcfg.encoder, tcfg.decoder
    widths = (enc.depth, enc.query_dim, enc.K, enc.codebook_size,
              dec.depth, dec.hidden_size, dec.num_heads, dec.renderer)
    if widths != (16, 512, 512, 32768, 24, 1536, 24, renderer):
        raise RuntimeError(f"not the flagship widths: {widths}")


def hold_grads(name, named, plain, ref="the plain step"):
    """Each gradient leaf of the kernel step against the reference step's
    (``ref``; on the host): the largest error within TRAIN_GRAD_TOL of the
    leaf's largest value, the cosine at least TRAIN_GRAD_COS."""
    worst = (0.0, 1.0, "")
    for (n, p), r in zip(named, plain):
        g = p.grad.detach().float()
        r = r.to(g.device).float()
        scale = r.abs().max().item()
        err = (g - r).abs().max().item()
        rel = err / scale if scale > 0 else (0.0 if err == 0 else math.inf)
        gn, rn = g.norm().item(), r.norm().item()
        cos = 1.0 if gn == rn == 0 else (g * r).sum().item() / max(gn * rn, 1e-30)
        if rel > TRAIN_GRAD_TOL or cos < TRAIN_GRAD_COS:
            raise RuntimeError(f"{name}: grad of {n} differs from {ref}'s: "
                               f"{rel} of its scale, cosine {cos}")
        worst = (max(worst[0], rel), min(worst[1], cos), n if rel >= worst[0] else worst[2])
    log(f"  {name} grads vs {ref}: {len(plain)} leaves, largest error {worst[0]:.3g} of "
        f"the leaf's scale ({worst[2]}), smallest cosine {worst[1]:.8f}")


def hold_loss(name, got, want, ref="the plain step"):
    if not (math.isfinite(got) and abs(got - want) <= TRAIN_LOSS_RTOL * abs(want)):
        raise RuntimeError(f"{name}: loss {got} differs from {ref}'s {want}")


def profile_train_step(fn, warm_s, label):
    """Device time of one extra step (a train step, or a sampler step of the
    zoo): busy share of the warm wall, the attention forward kernels' and
    the backward kernels' (the dQ pass and the dK / dV pass)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()

    def dev_us(e):
        return getattr(e, "self_device_time_total", None) or getattr(e, "self_cuda_time_total", 0)

    # kernel rows only: a range (the optimizer's) also shows as a device row
    # spanning its kernels
    rows = [(dev_us(e), e.count, e.key) for e in prof.key_averages()
            if e.device_type == DeviceType.CUDA and dev_us(e) > 0
            and not getattr(e, "is_user_annotation", False)]
    total = sum(r[0] for r in rows)
    if total <= 0:
        raise RuntimeError("torch.profiler recorded no device time")
    fwd = [r for r in rows if "flash_tf32_fwd_kernel" in r[2] or "flash_bf16_kernel" in r[2]]
    bwd = [r for r in rows if "flash_bwd_dq_kernel" in r[2] or "flash_bwd_dkdv_kernel" in r[2]]
    fwd_us, bwd_us = sum(r[0] for r in fwd), sum(r[0] for r in bwd)
    rows.sort(reverse=True)
    log(f"  profile of one warm {label} step: device busy {total / 1e6:.3f} s of {warm_s:.3f} s "
        f"wall = {total / 1e6 / warm_s:.3f}; {sum(r[1] for r in rows)} device kernels; "
        f"attention forward {fwd_us / 1e3:.2f} ms over {sum(r[1] for r in fwd)} launches "
        f"({fwd_us / total:.3f}), attention backward {bwd_us / 1e3:.2f} ms over "
        f"{sum(r[1] for r in bwd)} kernels ({bwd_us / total:.3f})")
    for us, n, key in rows[:10]:
        log(f"    {us / 1e3:9.2f} ms {us / total:6.3f} x{n:<6d} {key[:110]}")


def tokenizer_train_path(card, do_profile):
    """Three tokenizer train steps on the flagship at batch 4 (and
    TIMING_REPEATS more); the first (k-means init and dead-code
    reactivation on the 32768-code codebook) held against the same step
    with the plain versions forced. Returns the
    launch counts, the encoder's reference-named state dict and the VQ
    state."""
    import statistics

    from selftoktokenizer_tpu_torch.core.config import FLAGSHIP_CONFIG, load_config
    from selftoktokenizer_tpu_torch.models import vq as vq_mod
    from selftoktokenizer_tpu_torch.models.tokenizer import (
        ImageTokenizer, init_weights_, pre_vq_outs, tokenizer_config_from_params)
    from selftoktokenizer_tpu_torch.ops import routing
    from selftoktokenizer_tpu_torch.train import trainer as tr

    dev = "cuda"
    tcfg = tokenizer_config_from_params(dict(load_config(FLAGSHIP_CONFIG).tokenizer.params))
    check_train_widths(tcfg, renderer=False)
    torch.cuda.reset_peak_memory_stats()
    gen = torch.Generator(device=dev)
    gen.manual_seed(11)
    with torch.device(dev):
        tok = ImageTokenizer(tcfg)
    init_weights_(tok, gen, zero_init_std=0.02)
    tc = tr.TrainConfig()
    state = tr.make_train_state(tok, tcfg, tc)
    named = tr._trainable(tok)
    log(f"  tokenizer {sum(p.numel() for _, p in named) / 1e9:.3f} B trainable parameters, "
        f"use_checkpoint {tcfg.decoder.use_checkpoint}")
    B, K, C = TRAIN_BATCH, tcfg.k, tcfg.encoder.codebook_size
    batch = torch.randn((B, tcfg.latent_size, tcfg.latent_size, 16), generator=gen, device=dev)
    draws = {"t": torch.rand((B,), generator=gen, device=dev),
             "noise": torch.randn(batch.shape, generator=gen, device=dev),
             "drop_ids": torch.tensor([False, True, False, False], device=dev),
             "kmeans_idx": vq_mod.kmeans_init_indices(B * K, C, gen),
             "react_uniforms": torch.rand((C,), generator=gen, device=dev)}
    fwd_per_step = tcfg.decoder.depth * (2 if tcfg.decoder.use_checkpoint else 1)

    # step 1 with the plain versions forced, from the same state and draws
    before = counts()
    with routing.kernel_route("plain"):
        loss_p, aux_p, params = tr.tokenizer_grads(state, tcfg, batch, **draws)
        with torch.no_grad():
            # the top-2 margins of the step's ids: its scores against the
            # k-means codebook the step starts from
            q = tok.encoder.quantizer
            z = vq_mod.l2norm(vq_mod.project_in(q, pre_vq_outs(tok.encoder, tcfg, batch)[0]))
            z = z.reshape(B * K, -1)
            embed = vq_mod.kmeans_cosine(z, C, draws["kmeans_idx"],
                                         tcfg.quantizer.get("kmeans_iters", 10))
            top2 = torch.topk(z @ embed.t(), 2, dim=-1).values
            margins = (top2[:, 0] - top2[:, 1]).reshape(B, K)
    torch.cuda.synchronize()
    if counts() != before:
        raise RuntimeError("kernels='plain' launched a kernel")
    plain = [p.grad.detach().to("cpu", copy=True) for p in params]
    loss_p, ids_p = float(loss_p.detach()), aux_p["ids"]
    del aux_p, z, embed, top2

    # the counted steps: every count set to 0 just before each, read just after
    total = (0, 0, 0, 0, 0, 0)
    secs, peaks = [], []
    for step in range(3 + TIMING_REPEATS):
        reset_counts()
        torch.cuda.reset_peak_memory_stats()
        kw = draws if step == 0 else {"rng": gen}
        (state, logs), t = timed(lambda: tr.train_step(state, tcfg, tc, batch, **kw))
        c = counts()
        want = (0, fwd_per_step, 0, 0, fwd_per_step, tcfg.decoder.depth)
        if c != want:
            raise RuntimeError(f"tokenizer train step {step + 1}: launch counts {c}, "
                               f"expected {want}")
        total = tuple(a + b for a, b in zip(total, c))
        secs.append(t)
        peaks.append(torch.cuda.max_memory_allocated())
        loss, gnorm = float(logs["loss"]), float(logs["grad_norm"])
        if not (math.isfinite(loss) and math.isfinite(gnorm)):
            raise RuntimeError(f"tokenizer train step {step + 1}: loss {loss}, grad norm {gnorm}")
        log(f"  tokenizer train step {step + 1}: loss {loss:.6f}, grad norm {gnorm:.6g}, "
            f"n_reactive {int(logs['vq_n_reactive'])}, {t:.3f} s, peak "
            f"{peaks[-1] / 2**30:.2f} GiB, attention launches {c[1]}")
        if step == 0:
            hold_loss("tokenizer train step 1", loss, loss_p)
            hold_grads("tokenizer train step 1", named, plain)
            diff = logs["ids"] != ids_p
            if int((diff & (margins >= VQ_MARGIN)).sum()) != 0:
                raise RuntimeError("tokenizer train step 1: ids differ from the plain step's "
                                   "outside the margin")
            if int(logs["vq_n_reactive"]) <= 0:
                raise RuntimeError("tokenizer train step 1 reactivated no code")
            log(f"  tokenizer train step 1 vs plain: loss {loss:.8f} / {loss_p:.8f}, ids "
                f"differing {int(diff.sum())}/{diff.numel()} (smallest margin "
                f"{margins.min().item():.3g})")
            del plain
    if not torch.equal(tok.encoder.quantizer.embed, state.vq_state.embed):
        raise RuntimeError("the EMA codebook was not written back")
    warm_s = statistics.median(secs[1:])
    log(f"train tokenizer, batch {B}, fp32 (TF32 off): {warm_s:.3f} s a warm step (median of "
        f"steps 2-{len(secs)}: {', '.join(f'{t:.3f}' for t in secs[1:])}; step 1 {secs[0]:.3f} s), "
        f"peak memory {max(peaks[1:]) / 2**30:.2f} GiB warm ({peaks[0] / 2**30:.2f} GiB in "
        f"step 1) on {card}")
    if do_profile:
        profile_train_step(lambda: tr.train_step(state, tcfg, tc, batch, rng=gen), warm_s,
                           "tokenizer train")
    sd = {k: v.detach().to("cpu", copy=True) for k, v in tok.encoder.state_dict().items()}
    for k, v in vq_mod.vq_state_to_state_dict(state.vq_state).items():
        sd["quantizer." + k] = v.detach().to("cpu", copy=True)
    vq_state = state.vq_state.to("cpu")
    state.release()
    del tok, named, params, state
    release()
    return total, sd, vq_state


def renderer_train_path(card, do_profile, enc_sd, vq_state):
    """The trained tokenizer's encoder written as a reference .pth (under
    ``module.``), loaded back frozen through the pipeline's loader, and two
    renderer train steps at batch 4 (and TIMING_REPEATS more), the first
    held against the plain versions."""
    import os
    import statistics

    from selftoktokenizer_tpu_torch.core.config import FLAGSHIP_RENDERER_CONFIG, load_config
    from selftoktokenizer_tpu_torch.models.mmdit import MMDiT
    from selftoktokenizer_tpu_torch.models.tokenizer import (
        init_weights_, tokenizer_config_from_params)
    from selftoktokenizer_tpu_torch.ops import routing
    from selftoktokenizer_tpu_torch.pipeline import SelftokPipeline
    from selftoktokenizer_tpu_torch.train import trainer as tr

    dev = "cuda"
    cfg = load_config(FLAGSHIP_RENDERER_CONFIG)
    tcfg = tokenizer_config_from_params(dict(cfg.tokenizer.params))
    check_train_widths(tcfg, renderer=True)
    out_dir = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                           "selftoktokenizer_tpu_torch", "build")
    os.makedirs(out_dir, exist_ok=True)
    path = os.path.join(out_dir, "chip_smoke_tokenizer.pth")
    t0 = time.time()
    torch.save({"module.encoder." + k: v for k, v in enc_sd.items()}, path)
    size = os.path.getsize(path)
    try:
        pipe = SelftokPipeline(cfg, ckpt_path=path, encode_only=True, seed=0, zero_init_std=0.02,
                               datasize=tcfg.image_size, device=dev)
    finally:
        os.remove(path)
    log(f"  tokenizer .pth ({size / 2**20:.0f} MiB, the encoder and its VQ state under "
        f"module.) written and loaded back in {time.time() - t0:.1f} s")
    for k, v in pipe.encoder.state_dict().items():
        want = vq_state.embed[None] if k == "quantizer._codebook.embed" else enc_sd[k]
        if not torch.equal(v.cpu(), want):
            raise RuntimeError(f"the loaded encoder's {k} differs from the trained one")
    for f, v in vq_state.asdict().items():
        if not torch.equal(getattr(pipe.vq_state, f), v):
            raise RuntimeError(f"the loaded VQ state's {f} differs from the trained one")
    encoder = pipe.encoder
    if any(p.requires_grad for p in encoder.parameters()):
        raise RuntimeError("the loaded encoder is not frozen")

    torch.cuda.reset_peak_memory_stats()
    gen = torch.Generator(device=dev)
    gen.manual_seed(12)
    with torch.device(dev):
        model = MMDiT(tcfg.decoder)
    init_weights_(model, gen, zero_init_std=0.02)
    tc = tr.TrainConfig()
    state = tr.make_renderer_train_state(model, tc)
    named = tr._trainable(model)
    log(f"  renderer {sum(p.numel() for _, p in named) / 1e9:.3f} B trainable parameters")
    batch = torch.randn((TRAIN_BATCH, tcfg.latent_size, tcfg.latent_size, 16), generator=gen, device=dev)
    fwd = 2 * tcfg.decoder.depth * (2 if tcfg.decoder.use_checkpoint else 1)
    # the last block's context rows feed nothing: their attention gets no backward
    expect = (1, fwd, 0, 0, fwd, 2 * tcfg.decoder.depth - 1)

    before = counts()
    with routing.kernel_route("plain"):
        loss_p, _, params = tr.renderer_grads(state, tcfg, encoder, batch)
    torch.cuda.synchronize()
    if counts() != before:
        raise RuntimeError("kernels='plain' launched a kernel")
    plain = [p.grad.detach().to("cpu", copy=True) for p in params]
    loss_p = float(loss_p.detach())

    total = (0, 0, 0, 0, 0, 0)
    secs, peaks = [], []
    for step in range(2 + TIMING_REPEATS):
        reset_counts()
        torch.cuda.reset_peak_memory_stats()
        (state, logs), t = timed(lambda: tr.renderer_train_step(state, tcfg, tc, encoder, batch))
        c = counts()
        if c != expect:
            raise RuntimeError(f"renderer train step {step + 1}: launch counts {c}, "
                               f"expected {expect}")
        total = tuple(a + b for a, b in zip(total, c))
        secs.append(t)
        peaks.append(torch.cuda.max_memory_allocated())
        loss, gnorm = float(logs["loss"]), float(logs["grad_norm"])
        if not (math.isfinite(loss) and math.isfinite(gnorm)):
            raise RuntimeError(f"renderer train step {step + 1}: loss {loss}, grad norm {gnorm}")
        log(f"  renderer train step {step + 1}: loss {loss:.6f}, grad norm {gnorm:.6g}, "
            f"batch perplexity {float(logs['batch_perplexity']):.2f}, {t:.3f} s, peak "
            f"{peaks[-1] / 2**30:.2f} GiB, attention launches {c[1]}")
        if step == 0:
            hold_loss("renderer train step 1", loss, loss_p)
            hold_grads("renderer train step 1", named, plain)
            del plain
    warm_s = statistics.median(secs[1:])
    log(f"train renderer, batch {TRAIN_BATCH}, fp32 (TF32 off): {warm_s:.3f} s a warm step "
        f"(median of steps 2-{len(secs)}: {', '.join(f'{t:.3f}' for t in secs[1:])}; step 1 "
        f"{secs[0]:.3f} s), peak memory {max(peaks[1:]) / 2**30:.2f} GiB warm "
        f"({peaks[0] / 2**30:.2f} GiB in step 1) on {card}")
    if do_profile:
        profile_train_step(lambda: tr.renderer_train_step(state, tcfg, tc, encoder, batch),
                           warm_s, "renderer train")
    state.release()
    del model, named, params, state, encoder, pipe
    release()
    return total


# the accumulated step: held at the batch one step holds, timed at a
# global batch one step cannot hold (about 16 x 12 GiB of activations)
ACCUM_HOLD = (TRAIN_BATCH, 2)       # (global batch, microbatches)
ACCUM_TIMED = (16, 4)
ACCUM_TIMED_STEPS = 4


def _tokenizer_draws(tcfg, B, gen):
    dev = "cuda"
    from selftoktokenizer_tpu_torch.models import vq as vq_mod
    batch = torch.randn((B, tcfg.latent_size, tcfg.latent_size, 16), generator=gen, device=dev)
    C = tcfg.encoder.codebook_size
    return batch, {"t": torch.rand((B,), generator=gen, device=dev),
                   "noise": torch.randn(batch.shape, generator=gen, device=dev),
                   "drop_ids": torch.arange(B, device=dev) % 4 == 1,
                   "kmeans_idx": vq_mod.kmeans_init_indices(B * tcfg.k, C, gen),
                   "react_uniforms": torch.rand((C,), generator=gen, device=dev)}


def _margins(tok, tcfg, batch):
    """Top-2 score gap of each token against the codebook the step
    quantizes against (an initted state's)."""
    from selftoktokenizer_tpu_torch.models import vq as vq_mod
    from selftoktokenizer_tpu_torch.models.tokenizer import pre_vq_outs
    with torch.no_grad():
        q = tok.encoder.quantizer
        z = vq_mod.l2norm(vq_mod.project_in(q, pre_vq_outs(tok.encoder, tcfg, batch)[0]))
        top2 = torch.topk(z @ q.embed.float().t(), 2, dim=-1).values
    return top2[..., 0] - top2[..., 1]


def _hold_against_train_step(name, state, tcfg, batch, draws, grads_fn, expect):
    """``grads_fn`` (the accumulated or data-parallel step's gradient half)
    against ``tr.tokenizer_grads`` (train_step's) from the same state and
    draws: loss, every gradient leaf, the VQ buffers, ids outside the top-2
    margin."""
    from selftoktokenizer_tpu_torch.train import trainer as tr
    named = tr._trainable(state.model)
    margins = _margins(state.model, tcfg, batch)
    loss_g, aux, params = tr.tokenizer_grads(state, tcfg, batch, **dict(draws))
    plain = [p.grad.detach().to("cpu", copy=True) for p in params]
    loss_g, ids_g, vq_g = float(loss_g.detach()), aux["ids"], aux["vq_state"]
    del aux
    before = counts()
    logs, vq, _ = grads_fn()
    torch.cuda.synchronize()
    c = tuple(a - b for a, b in zip(counts(), before))
    if c != expect:
        raise RuntimeError(f"{name}: launch counts {c}, expected {expect}")
    hold_loss(name, float(logs["loss"]), loss_g, "train_step")
    hold_grads(name, named, plain, "train_step")
    del plain
    worst = 0.0
    for f in ("embed", "cluster_size", "embed_avg", "timestep_p_over_c", "count"):
        a, b = getattr(vq, f).float(), getattr(vq_g, f).float()
        rel = (a - b).abs().max().item() / max(b.abs().max().item(), 1e-30)
        if rel > TRAIN_VQ_TOL:
            raise RuntimeError(f"{name}: VQ buffer {f} differs from train_step's by {rel} "
                               "of its scale")
        worst = max(worst, rel)
    diff = logs["ids"] != ids_g
    if int((diff & (margins >= VQ_MARGIN)).sum()) != 0:
        raise RuntimeError(f"{name}: ids differ from train_step's outside the margin")
    log(f"  {name} vs train_step: loss {float(logs['loss']):.8f} / {loss_g:.8f}, VQ buffers "
        f"within {worst:.3g} of their scale, ids differing {int(diff.sum())}/{diff.numel()} "
        f"(smallest margin {margins.min().item():.3g}), attention launches {c[1]}")


def tokenizer_accum_and_dp_paths(card, do_profile):
    """On one initted flagship train state (a fresh tokenizer after one
    k-means init step at batch 4): path "tokenizer accum", the accumulated
    step's gradients at a global batch 4 in 2 microbatches held against
    train_step's, then ACCUM_TIMED_STEPS steps at a global batch 16 in 4;
    path "tokenizer data-parallel, one rank", a one-rank NCCL group over a
    FileStore, the data-parallel step's gradients (``accum_grads`` over the
    group) held against train_step's, then
    two dp_train_steps. Every count is set to 0 at the start of each path
    and read at its end (train_step's reference calls included). Returns
    the launch counts of the two paths."""
    import os
    import statistics
    import tempfile

    from selftoktokenizer_tpu_torch.core.config import FLAGSHIP_CONFIG, load_config
    from selftoktokenizer_tpu_torch.models.tokenizer import (
        ImageTokenizer, init_weights_, tokenizer_config_from_params)
    from selftoktokenizer_tpu_torch.parallel import distributed as pdist
    from selftoktokenizer_tpu_torch.train import trainer as tr

    dev = "cuda"
    tcfg = tokenizer_config_from_params(dict(load_config(FLAGSHIP_CONFIG).tokenizer.params))
    check_train_widths(tcfg, renderer=False)
    gen = torch.Generator(device=dev)
    gen.manual_seed(13)
    with torch.device(dev):
        tok = ImageTokenizer(tcfg)
    init_weights_(tok, gen, zero_init_std=0.02)
    tc = tr.TrainConfig()
    state = tr.make_train_state(tok, tcfg, tc)
    per_mb = tcfg.decoder.depth * (2 if tcfg.decoder.use_checkpoint else 1)
    depth = tcfg.decoder.depth

    # path "tokenizer accum"
    reset_counts()
    batch, draws = _tokenizer_draws(tcfg, TRAIN_BATCH, gen)
    state, logs = tr.train_step(state, tcfg, tc, batch, **draws)      # the k-means init step
    B, n_micro = ACCUM_HOLD
    batch, draws = _tokenizer_draws(tcfg, B, gen)
    _hold_against_train_step(
        f"tokenizer accum (batch {B}, {n_micro} microbatches)", state, tcfg, batch, draws,
        lambda: tr.accum_grads(state, tcfg, batch, n_micro, **dict(draws)),
        (0, n_micro * per_mb, 0, 0, n_micro * per_mb, n_micro * depth))
    B, n_micro = ACCUM_TIMED
    batch = torch.randn((B, tcfg.latent_size, tcfg.latent_size, 16), generator=gen, device=dev)
    secs, peaks = [], []
    for step in range(ACCUM_TIMED_STEPS):
        before = counts()
        torch.cuda.reset_peak_memory_stats()
        (state, logs), t = timed(lambda: tr.train_step_accum(state, tcfg, tc, batch, n_micro,
                                                             rng=gen))
        c = tuple(a - b for a, b in zip(counts(), before))
        if c != (0, n_micro * per_mb, 0, 0, n_micro * per_mb, n_micro * depth):
            raise RuntimeError(f"tokenizer accum step {step + 1}: launch counts {c}")
        secs.append(t)
        peaks.append(torch.cuda.max_memory_allocated() / 2**30)
        loss, gnorm = float(logs["loss"]), float(logs["grad_norm"])
        if not (math.isfinite(loss) and math.isfinite(gnorm)):
            raise RuntimeError(f"tokenizer accum step {step + 1}: loss {loss}, grad norm {gnorm}")
        log(f"  tokenizer accum step {step + 1} (batch {B}, {n_micro} x {B // n_micro}): loss "
            f"{loss:.6f}, grad norm {gnorm:.6g}, n_reactive {int(logs['vq_n_reactive'])}, "
            f"{t:.3f} s, peak {peaks[-1]:.2f} GiB, attention launches {c[1]}")
    if not torch.equal(tok.encoder.quantizer.embed, state.vq_state.embed):
        raise RuntimeError("tokenizer accum: the EMA codebook was not written back")
    warm_s = statistics.median(secs[1:])
    log(f"train tokenizer accum, global batch {B} in {n_micro} microbatches, fp32 (TF32 off): "
        f"{warm_s:.3f} s a warm step (median of steps 2-{len(secs)}: "
        f"{', '.join(f'{t:.3f}' for t in secs[1:])}; step 1 {secs[0]:.3f} s), peak memory "
        f"{max(peaks):.2f} GiB, attention launches {n_micro * per_mb} a step on {card}")
    accum_total = counts()
    if do_profile:
        profile_train_step(lambda: tr.train_step_accum(state, tcfg, tc, batch, n_micro, rng=gen),
                           warm_s, f"tokenizer accum (batch {B})")

    # path "tokenizer data-parallel, one rank"
    reset_counts()
    B = TRAIN_BATCH
    with tempfile.TemporaryDirectory() as d:
        if not pdist.init(backend="nccl", init_method=f"file://{os.path.join(d, 'store')}",
                          rank=0, world_size=1):
            raise RuntimeError("tokenizer data-parallel: no process group formed")
        try:
            log(f"  process group: {torch.distributed.get_backend()}, world "
                f"{torch.distributed.get_world_size()}")
            batch, draws = _tokenizer_draws(tcfg, B, gen)
            _hold_against_train_step(
                f"tokenizer data-parallel (batch {B}, one rank)", state, tcfg, batch, draws,
                lambda: tr.accum_grads(state, tcfg, pdist.local_rows(batch), 1,
                                       group=torch.distributed.group.WORLD, **dict(draws)),
                (0, per_mb, 0, 0, per_mb, depth))
            secs, peaks = [], []
            for step in range(2):
                before = counts()
                torch.cuda.reset_peak_memory_stats()
                (state, logs), t = timed(lambda: tr.dp_train_step(
                    state, tcfg, tc, pdist.local_rows(batch), rng=gen))
                c = tuple(a - b for a, b in zip(counts(), before))
                if c != (0, per_mb, 0, 0, per_mb, depth):
                    raise RuntimeError(f"dp_train_step {step + 1}: launch counts {c}")
                secs.append(t)
                peaks.append(torch.cuda.max_memory_allocated() / 2**30)
                if not math.isfinite(float(logs["loss"])):
                    raise RuntimeError(f"dp_train_step {step + 1}: loss {float(logs['loss'])}")
            log(f"train tokenizer data-parallel, one rank, batch {B}, fp32 (TF32 off): "
                f"{secs[-1]:.3f} s the second step (first {secs[0]:.3f} s), peak memory "
                f"{max(peaks):.2f} GiB on {card}")
            dp_total = counts()
            if do_profile:
                profile_train_step(lambda: tr.dp_train_step(
                    state, tcfg, tc, pdist.local_rows(batch), rng=gen), secs[-1],
                    "tokenizer data-parallel (one rank)")
        finally:
            torch.distributed.destroy_process_group()
    state.release()
    del tok, state
    release()
    return accum_total, dp_total


VAE_BATCH = 8
VAE_SIZE = 256
VAE_STEPS = 5
VAE_LR = 1e-5


def vae_train_path(card, do_profile):
    """The SD3 VAE's trainer at its own widths (ch 128, ch_mult (1, 2, 4, 4),
    two res blocks, z 16) at 256 px, batch 8, bf16: VAE_STEPS steps on one
    seeded batch of smooth images and one reparametrisation draw, every loss
    finite and the last below the first; then the evaluation's PSNR and
    SSIM. No kernel is on this path
    (the 3-channel conv kernel has no backward; JAX's trainer has none)."""
    import statistics

    import torch.nn.functional as F

    from selftoktokenizer_tpu_torch.models.tokenizer import init_weights_
    from selftoktokenizer_tpu_torch.models.vae import SDVAE, VAEConfig
    from selftoktokenizer_tpu_torch.train import vae as tv

    dev = "cuda"
    cfg = VAEConfig()
    if (cfg.ch, cfg.ch_mult, cfg.num_res_blocks, cfg.z_channels) != (128, (1, 2, 4, 4), 2, 16):
        raise RuntimeError(f"not the SD3 VAE's widths: {cfg}")
    size = VAE_SIZE
    gen = torch.Generator(device=dev)
    gen.manual_seed(14)
    with torch.device(dev):
        vae = SDVAE(cfg)
    init_weights_(vae, gen, zero_init_std=0.02)
    tc = tv.VAETrainConfig(lr=VAE_LR, warmup_steps=0, max_steps=1000)
    state = tv.make_vae_train_state(vae, tc)
    coarse = torch.rand((VAE_BATCH, 3, 8, 8), generator=gen, device=dev) * 2 - 1
    images = F.interpolate(coarse, size=(size, size), mode="bilinear",
                           align_corners=False).permute(0, 2, 3, 1).contiguous()
    noise = torch.randn((VAE_BATCH, size // 8, size // 8, cfg.z_channels), generator=gen,
                        device=dev)
    log(f"  VAE {sum(p.numel() for p in vae.parameters()) / 1e6:.1f} M parameters, images "
        f"{tuple(images.shape)}, lr {tc.lr}")
    reset_counts()
    losses, secs, peaks = [], [], []
    for step in range(VAE_STEPS):
        torch.cuda.reset_peak_memory_stats()
        (state, logs), t = timed(lambda: tv.vae_train_step(state, cfg, tc, images, noise=noise))
        losses.append(float(logs["loss"]))
        secs.append(t)
        peaks.append(torch.cuda.max_memory_allocated() / 2**30)
        log(f"  VAE train step {step + 1}: loss {losses[-1]:.6f} (l1 {float(logs['l1']):.5f}, "
            f"mse {float(logs['mse']):.5f}, kl {float(logs['kl']):.4g}), grad norm "
            f"{float(logs['grad_norm']):.5g}, {t:.3f} s, peak {peaks[-1]:.2f} GiB")
        if not math.isfinite(losses[-1]):
            raise RuntimeError(f"VAE train step {step + 1}: loss {losses[-1]}")
    if not losses[-1] < losses[0]:
        raise RuntimeError(f"VAE train: the loss did not fall over {VAE_STEPS} steps: {losses}")
    (p, s_), t_eval = timed(lambda: tv.vae_eval_psnr(vae, cfg, images))
    p, s_ = float(p), float(s_)
    if not (math.isfinite(p) and -1.0 <= s_ <= 1.0):
        raise RuntimeError(f"VAE eval: PSNR {p}, SSIM {s_}")
    c = counts()
    warm_s = statistics.median(secs[1:])
    log(f"train VAE (SD3 widths), batch {VAE_BATCH}, {size} px, bf16: {warm_s:.3f} s a warm step "
        f"(median of steps 2-{len(secs)}; step 1 {secs[0]:.3f} s), peak memory {max(peaks):.2f} "
        f"GiB; loss {losses[0]:.5f} -> {losses[-1]:.5f}; eval PSNR {p:.3f} dB, SSIM {s_:.4f} "
        f"({t_eval:.3f} s) on {card}")
    if do_profile:
        profile_train_step(lambda: tv.vae_train_step(state, cfg, tc, images, noise=noise), warm_s,
                           "VAE train")
    del vae, state, images
    release()
    return c


def train_phase(card, do_profile):
    """Training at the flagship widths, fp32 with TF32 off (the global flags
    come back afterwards), and the VAE's trainer in bf16."""
    prev = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
    try:
        tok_counts, enc_sd, vq_state = tokenizer_train_path(card, do_profile)
        rend_counts = renderer_train_path(card, do_profile, enc_sd, vq_state)
        del enc_sd, vq_state
        accum_counts, dp_counts = tokenizer_accum_and_dp_paths(card, do_profile)
        vae_counts = vae_train_path(card, do_profile)
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = prev
    return {"tokenizer train": tok_counts, "renderer train": rend_counts,
            "tokenizer accum": accum_counts, "tokenizer data-parallel, one rank": dp_counts,
            "VAE train": vae_counts}


# --------------------------------------------------------------- sharded ---

SHARDED_SEED = 17
SHARDED_STEPS = 3


def _sharded_reference(tcfg, tc, gen, dev):
    """A fresh flagship tokenizer on ``dev`` from SHARDED_SEED, and its first
    (k-means init) train step's gradient half through ``tokenizer_grads``,
    unsharded: returns (the weights' CPU copy, the batch and draws, the
    reference: loss, gradients by name on the CPU, VQ state, ids, the ids'
    top-2 margins against the k-means codebook, and the pre-VQ outputs)."""
    from selftoktokenizer_tpu_torch.models import vq as vq_mod
    from selftoktokenizer_tpu_torch.models.tokenizer import (
        ImageTokenizer, init_weights_, pre_vq_outs)
    from selftoktokenizer_tpu_torch.train import trainer as tr

    with torch.device(dev):
        tok = ImageTokenizer(tcfg)
    init_weights_(tok, gen, zero_init_std=0.02)
    sd0 = {k: v.detach().to("cpu", copy=True) for k, v in tok.state_dict().items()}
    batch, draws = _tokenizer_draws(tcfg, TRAIN_BATCH, gen)
    ref = tr.make_train_state(tok, tcfg, tc)
    loss, aux, params = tr.tokenizer_grads(ref, tcfg, batch, **dict(draws))
    ids, vq = aux["ids"], aux["vq_state"]
    grads = {n: p.grad.detach().to("cpu", copy=True) for n, p in tr._trainable(tok)}
    with torch.no_grad():
        q = tok.encoder.quantizer
        outs = pre_vq_outs(tok.encoder, tcfg, batch)[0]
        z = vq_mod.l2norm(vq_mod.project_in(q, outs))
        z = z.reshape(TRAIN_BATCH * tcfg.k, -1)
        embed = vq_mod.kmeans_cosine(z, tcfg.encoder.codebook_size, draws["kmeans_idx"],
                                     tcfg.quantizer.get("kmeans_iters", 10))
        top2 = torch.topk(z @ embed.t(), 2, dim=-1).values
        margins = (top2[:, 0] - top2[:, 1]).reshape(TRAIN_BATCH, tcfg.k).cpu()
    want = {"loss": float(loss.detach()), "grads": grads, "vq": vq.to("cpu"),
            "ids": ids.cpu(), "margins": margins, "outs": outs.cpu()}
    ref.release()
    del tok, ref, aux, params, loss, ids, vq, outs, z, embed, top2
    release()
    return sd0, batch, draws, want


def _sharded_steps(name, tcfg, tc, sd0, batch, draws, want, mesh, gen, dev, leader,
                   do_profile=False):
    """The sharded state over ``mesh`` (FSDP2 and the tensor-parallel
    wrappers, whatever the axis sizes) from the weights sd0: step 1 from
    the reference's draws held against it (on the leader, after the whole
    gradients are gathered), then SHARDED_STEPS - 1 steps from ``gen``,
    every count set to 0 just before each step and read just after; with
    do_profile, one more step under the profiler. Returns (launch counts
    summed over the steps, warm step seconds, peak GiB of this rank)."""
    from types import SimpleNamespace

    from selftoktokenizer_tpu_torch.models import vq as vq_mod
    from selftoktokenizer_tpu_torch.models.tokenizer import ImageTokenizer, pre_vq_outs
    from selftoktokenizer_tpu_torch.parallel import distributed as pdist
    from selftoktokenizer_tpu_torch.train import trainer as tr

    with torch.device(dev):
        tok = ImageTokenizer(tcfg)
    tok.load_state_dict(sd0)
    state = tr.make_train_state(tok, tcfg, tc, mesh=mesh, tp=True)
    sh = state.sharding
    vq_ref = {**want, "name": "train_step"} if leader else None
    if pdist.rank_and_world(sh.dp_group)[1] > 1:
        # the ranks' encoders see fewer rows than the reference's, and the
        # dead-code reactivation (an inverse CDF over the tokens) turns an
        # ulp of the pre-VQ outputs into another token for a code: phase A
        # is held on the sharded encoder's own outputs (gathered as the step
        # gathers them), those against the reference's
        with torch.no_grad():
            outs = pdist.all_gather_rows(state.model.run(
                lambda m: pre_vq_outs(m.encoder, tcfg, sh.local_rows(batch))[0]), sh.dp_group)
            _, ids, _, vq, _ = state.model.run(lambda m: vq_mod.vq_train_apply(
                m.encoder.quantizer, state.vq_state, outs, tcfg.quantizer,
                kmeans_idx=draws["kmeans_idx"], react_uniforms=draws["react_uniforms"]))
        if leader:
            rel = ((outs.cpu() - want["outs"]).abs().max().item()
                   / want["outs"].abs().max().item())
            if rel > TRAIN_VQ_TOL:
                raise RuntimeError(f"{name}: the pre-VQ outputs differ from train_step's by "
                                   f"{rel} of their scale")
            log(f"  {name}: pre-VQ outputs within {rel:.3g} of train_step's")
            vq_ref = {**want, "vq": vq.to("cpu"), "ids": ids.cpu(),
                      "name": "phase A on these outputs"}
        del outs, ids, vq
    fwd = tcfg.decoder.depth * (2 if tcfg.decoder.use_checkpoint else 1)
    per_step = (0, fwd, 0, 0, fwd, tcfg.decoder.depth)
    total = (0, 0, 0, 0, 0, 0)
    secs, peaks = [], []
    for step in range(SHARDED_STEPS):
        kw = dict(draws) if step == 0 else {"rng": gen}
        reset_counts()
        torch.cuda.reset_peak_memory_stats()
        (state, logs), t = timed(lambda: tr.dp_train_step(state, tcfg, tc, sh.local_rows(batch),
                                                          **kw))
        c = counts()
        if c != per_step:
            raise RuntimeError(f"{name} step {step + 1}: launch counts {c}, expected {per_step}")
        total = tuple(a + b for a, b in zip(total, c))
        secs.append(t)
        peaks.append(torch.cuda.max_memory_allocated() / 2**30)
        loss, gnorm = float(logs["loss"]), float(logs["grad_norm"])
        if not (math.isfinite(loss) and math.isfinite(gnorm)):
            raise RuntimeError(f"{name} step {step + 1}: loss {loss}, grad norm {gnorm}")
        if leader:
            log(f"  {name} step {step + 1}: loss {loss:.6f}, grad norm {gnorm:.6g}, {t:.3f} s, "
                f"peak {peaks[-1]:.2f} GiB a rank, attention launches {c[1]}")
        if step == 0:
            # the whole gradients (a collective), held on the leader
            full = [(n, SimpleNamespace(grad=sh.full(n, p.grad.detach())))
                    for n, p in tr._trainable(tok)]
            if leader:
                hold_loss(f"{name} step 1", loss, want["loss"], "train_step")
                hold_grads(f"{name} step 1", full, [want["grads"][n] for n, _ in full],
                           "train_step")
                worst = 0.0
                for f in ("embed", "cluster_size", "embed_avg", "timestep_p_over_c", "count"):
                    a = getattr(state.vq_state, f).float().cpu()
                    b = getattr(vq_ref["vq"], f).float()
                    rel = (a - b).abs().max().item() / max(b.abs().max().item(), 1e-30)
                    if rel > TRAIN_VQ_TOL:
                        raise RuntimeError(f"{name}: VQ buffer {f} differs from "
                                           f"{vq_ref['name']} by {rel} of its scale")
                    worst = max(worst, rel)
                diff = logs["ids"].cpu() != vq_ref["ids"]
                if int((diff & (want["margins"] >= VQ_MARGIN)).sum()) != 0:
                    raise RuntimeError(f"{name}: ids differ from {vq_ref['name']} outside "
                                       "the margin")
                log(f"  {name} step 1 vs train_step: loss {loss:.8f} / {want['loss']:.8f}, VQ "
                    f"buffers within {worst:.3g} of {vq_ref['name']}, ids differing "
                    f"{int(diff.sum())}/{diff.numel()}")
            del full
    codebook = sh.full(tr.CODEBOOK, tok.encoder.quantizer._codebook.embed.detach())
    if not torch.equal(codebook[0], state.vq_state.embed):
        raise RuntimeError(f"{name}: the EMA codebook was not written into the shards")
    warm_s = statistics.median(secs[1:])
    if do_profile:
        profile_train_step(lambda: tr.dp_train_step(state, tcfg, tc, sh.local_rows(batch),
                                                    rng=gen), warm_s, name)
    state.release()
    del tok, state, sh
    release()
    return total, warm_s, max(peaks)


def _sharded_rank(rank, world, shape, store, out_dir):
    """One NCCL rank a card of the multi-card meshes (``spawn``ed)."""
    import datetime
    import os

    from selftoktokenizer_tpu_torch.core.config import FLAGSHIP_CONFIG, load_config
    from selftoktokenizer_tpu_torch.models.tokenizer import tokenizer_config_from_params
    from selftoktokenizer_tpu_torch.parallel import distributed as pdist
    from selftoktokenizer_tpu_torch.parallel.mesh import make_mesh
    from selftoktokenizer_tpu_torch.train import trainer as tr

    os.environ["LOCAL_RANK"] = str(rank)
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
    dev = f"cuda:{rank}"
    # a collective that waits 5 minutes ends the rank (a step takes seconds)
    pdist.init(backend="nccl", init_method=f"file://{store}", rank=rank, world_size=world,
               timeout=datetime.timedelta(minutes=5))
    tcfg = tokenizer_config_from_params(dict(load_config(FLAGSHIP_CONFIG).tokenizer.params))
    tc = tr.TrainConfig()
    gen = torch.Generator(device=dev)
    gen.manual_seed(SHARDED_SEED)
    # every rank draws the same weights and batch; rank 0 alone keeps the
    # unsharded reference
    sd0, batch, draws, want = _sharded_reference(tcfg, tc, gen, dev)
    if rank != 0:
        want = None
    mesh = make_mesh(*shape)
    total, warm_s, peak = _sharded_steps(f"tokenizer sharded {shape}", tcfg, tc, sd0, batch,
                                         draws, want, mesh, gen, dev, rank == 0)
    peaks = pdist.allgather_f64([peak])[:, 0].tolist()
    if rank == 0:
        with open(os.path.join(out_dir, "result.json"), "w") as f:
            json.dump({"counts": total, "warm_s": warm_s, "peaks": peaks}, f)
    # only on success: a rank that raised exits with its error, and the
    # parent's join ends the others (destroying the group would wait on them)
    torch.distributed.destroy_process_group()


def sharded_phase(card, do_profile=False):
    """Sharded training at the flagship widths, fp32 with TF32 off: path
    "tokenizer sharded", a one-rank NCCL group (FileStore) with the mesh
    (1, 1, 1), the tokenizer through the FSDP2 and tensor-parallel wrappers
    for SHARDED_STEPS steps, the first held against the unsharded
    ``train_step`` on the same card, weights and draws; with 2 or more
    cards, one NCCL rank a card for (1, 2, 1), (1, 1, 2) and, with 4,
    (1, 2, 2), each held the same way on rank 0 (phase A, where the rows
    are split, on the sharded encoder's own outputs, held against the
    unsharded encoder's)."""
    import os
    import tempfile

    import torch.multiprocessing as mp

    from selftoktokenizer_tpu_torch.core.config import FLAGSHIP_CONFIG, load_config
    from selftoktokenizer_tpu_torch.models.tokenizer import tokenizer_config_from_params
    from selftoktokenizer_tpu_torch.parallel import distributed as pdist
    from selftoktokenizer_tpu_torch.parallel.mesh import make_mesh
    from selftoktokenizer_tpu_torch.train import trainer as tr

    prev = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
    paths = {}
    try:
        dev = "cuda"
        tcfg = tokenizer_config_from_params(dict(load_config(FLAGSHIP_CONFIG).tokenizer.params))
        check_train_widths(tcfg, renderer=False)
        tc = tr.TrainConfig()
        gen = torch.Generator(device=dev)
        gen.manual_seed(SHARDED_SEED)
        sd0, batch, draws, want = _sharded_reference(tcfg, tc, gen, dev)
        with tempfile.TemporaryDirectory() as d:
            if not pdist.init(backend="nccl", init_method=f"file://{os.path.join(d, 'store')}",
                              rank=0, world_size=1):
                raise RuntimeError("tokenizer sharded: no process group formed")
            try:
                mesh = make_mesh(1, 1, 1)
                total, warm_s, peak = _sharded_steps(
                    "tokenizer sharded (1, 1, 1)", tcfg, tc, sd0, batch, draws, want, mesh, gen,
                    dev, True, do_profile)
            finally:
                torch.distributed.destroy_process_group()
        del sd0, batch, draws, want
        release()
        paths["tokenizer sharded"] = total
        log(f"train tokenizer sharded, mesh (1, 1, 1) (FSDP2 + tensor-parallel wrappers), batch "
            f"{TRAIN_BATCH}, fp32 (TF32 off): {warm_s:.3f} s a warm step (median of steps "
            f"2-{SHARDED_STEPS}), peak memory {peak:.2f} GiB a rank, attention launches "
            f"{total[1] // SHARDED_STEPS} a rank-step on {card}")
        n = torch.cuda.device_count()
        meshes = ([(1, 2, 1), (1, 1, 2)] if n >= 2 else []) + ([(1, 2, 2)] if n >= 4 else [])
        for shape in meshes:
            world = math.prod(shape)
            with tempfile.TemporaryDirectory() as d:
                mp.start_processes(_sharded_rank, args=(world, shape, os.path.join(d, "store"), d),
                                   nprocs=world, start_method="spawn")
                with open(os.path.join(d, "result.json")) as f:
                    res = json.load(f)
            paths[f"tokenizer sharded {shape}"] = tuple(res["counts"])
            log(f"train tokenizer sharded, mesh {shape}, {world} ranks, batch {TRAIN_BATCH}, "
                f"fp32 (TF32 off): {res['warm_s']:.3f} s a warm step on rank 0, peak memory "
                f"{', '.join(f'{p:.2f}' for p in res['peaks'])} GiB by rank, attention launches "
                f"{res['counts'][1] // SHARDED_STEPS} a rank-step on {card}")
        log(f"  sharded meshes run: {[(1, 1, 1)] + meshes} on {n} card(s)")
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = prev
    return paths


# ----------------------------------------------------------------- tools ---

# the keys each measurement tool documents for its JSON line
TOOL_KEYS = {
    "measure_k1024": {"ts", "build_s", "platform", "card", "k", "batch", "vq_rows",
                      "rates_img_per_s", "median", "note"},
    "bench_encode_serving": {"batch", "card", "encode_images_per_s", "encoder_stage_images_per_s",
                             "id_agreement_serving_vs_plain"},
    "bench_encoder_bisect": {"shapes", "prec", "card", "rows", "full_ms",
                             "full_trunk_images_per_s", "calibration", "proxy"},
    "bench_flash": {"metric", "dtype", "iters", "card", "rows", "block_q_sweep"},
    "bench_decode512": {"data_size", "batch", "steps", "card", "segments", "joint_lengths",
                        "variants", "sweeps"},
    "bench_int8": {"metric", "bf16_img_per_s", "int8_img_per_s", "speedup",
                   "psnr_int8_vs_bf16_db", "q8_matmul_launches_per_int8_decode", "steps", "batch",
                   "platform", "card"},
    "bench_render_overlap": {"batch", "iters", "card", "loops", "max_abs_diff_vs_fused",
                             "images_equal"},
    "bench_train": {"platform", "card", "depth", "hidden", "batch", "remat", "peak",
                    "train_flops_per_step_T", "flash_step_s", "flash_images_per_s",
                    "flash_tflops", "flash_share_of_peak", "flash_loss"},
    "bench_scaling": {"metric", "results", "world", "batch_per_chip", "backend", "card"},
    "bench_loader": {"n", "size", "batch", "native_available", "native_unavailable_reason",
                     "native_loader_img_per_s", "native_single_img_per_s", "pil_img_per_s",
                     "tar_loader_img_per_s", "tar_decoder", "tar_decoded"},
}
TOOLS_512 = 512                   # px of the 512 px encode and decode
TOOLS_REMAT = (24, 8)             # bench_train's decoder depth (width 64 x 24 = 1536), batch


def run_tool(name, argv):
    """The tool's main in process, counted from 0; its JSON line held to
    its documented keys. Returns (line, counts)."""
    import importlib

    mod = importlib.import_module(f"selftoktokenizer_tpu_torch.tools.{name}")
    release()
    reset_counts()
    line, t = timed(lambda: mod.main(argv))
    c = counts()
    missing = TOOL_KEYS[name] - set(line)
    if missing:
        raise RuntimeError(f"{name}: its JSON line lacks {sorted(missing)}")
    log(f"  tool {name} {' '.join(argv)}: {t:.1f} s, launches "
        f"{dict(zip(KERNEL_NAMES, c))}")
    release()
    return line, c


def check_ids_rule(name, ids, ids_p, margins, margin):
    """ids from the kernels may differ from the plain run's only where the
    top-2 margin is below ``margin``."""
    diff = ids != ids_p
    bad = int((diff & (margins >= margin)).sum())
    if bad:
        raise RuntimeError(f"{name}: {bad} ids differ from the plain run's outside margin {margin}")
    return 1.0 - diff.float().mean().item()


def encode_decode_512_path(card):
    """The flagship at 512 px: the encode at batch 8 at 'highest' and
    'default', then the 50-step bf16 decode of two of those id rows at
    batch 2, each against the same calls with the plain versions forced."""
    from selftoktokenizer_tpu_torch.core.config import FLAGSHIP_CONFIG
    from selftoktokenizer_tpu_torch.tools import common

    px = TOOLS_512
    pipe = common.seeded_pipeline(FLAGSHIP_CONFIG, "cuda", datasize=px, steps=50,
                                  decode_dtype=torch.bfloat16, encode_precision="highest")
    check_decoder_widths(pipe)
    depth = pipe.tcfg.decoder.depth
    gen = torch.Generator(device="cuda")
    gen.manual_seed(23)
    images = torch.rand((8, px, px, 3), generator=gen, device="cuda") * 2 - 1
    noise = torch.randn((2, px // 8, px // 8, 16), generator=gen, device="cuda")
    pipe.encoding(images[:1])                     # warm-up outside the counted run
    reset_counts()
    ids_hi, t_hi = timed(lambda: pipe.encoding(images))
    c1 = counts()
    ids_def, t_def = timed(lambda: pipe.encoding(images, precision="default"))
    c2 = counts()
    (img, lat), t_dec = timed(lambda: pipe.decoding(ids_hi[:2], noise=noise, cfg_scale=1.0,
                                                    return_latents=True))
    c3_ = counts()
    n_q = pipe.tcfg.encoder.depth
    expect = [(1, 0, 0, 0, 0, 0), (2, n_q, 0, 0, 0, 0), (2, n_q + depth * 50, 0, 0, 0, 0)]
    if [c1, c2, c3_] != expect:
        raise RuntimeError(f"512 px: launch counts {[c1, c2, c3_]} differ from {expect}")
    for ids in (ids_hi, ids_def):
        if tuple(ids.shape) != (8, 512) or int(ids.min()) < 0 or int(ids.max()) >= 32768:
            raise RuntimeError(f"512 px: bad ids {tuple(ids.shape)}")
    if tuple(img.shape) != (2, px, px, 3) or not torch.isfinite(img).all() \
            or float(img.min()) < 0 or float(img.max()) > 1:
        raise RuntimeError(f"512 px: bad images {tuple(img.shape)}")
    segs = pipe._decode_segments()
    before = counts()
    ids_hi_p = pipe.encoding(images, kernels="plain")
    ids_def_p = pipe.encoding(images, precision="default", kernels="plain")
    _, margins = pipe.encoding_margins(images, kernels="plain")
    _, lat_p = pipe.decoding(ids_hi[:2], noise=noise, cfg_scale=1.0, kernels="plain",
                             return_latents=True)
    torch.cuda.synchronize()
    if counts() != before:
        raise RuntimeError("kernels='plain' launched a kernel")
    check_ids_rule("512 px 'highest'", ids_hi, ids_hi_p, margins, VQ_MARGIN)
    agree = check_ids_rule("512 px 'default'", ids_def, ids_def_p, margins, DEFAULT_TIER_MARGIN)
    if agree < 0.5:
        raise RuntimeError(f"512 px 'default': only {agree:.3f} of ids agree with the plain path")
    if not torch.isfinite(lat).all():
        raise RuntimeError("512 px: non-finite latents")
    e = (lat - lat_p).abs().max().item()
    if e > LATENT_TOL:
        raise RuntimeError(f"512 px decode latents differ from the plain path by {e} > {LATENT_TOL}")
    log(f"  512 px: decode buckets (start, end, context length) {segs}; kernels vs forced plain: "
        f"'highest' ids differing {int((ids_hi != ids_hi_p).sum())}/{ids_hi.numel()}, 'default' "
        f"agreeing {agree:.4f}, latents max abs diff {e:.4g} (latent abs max "
        f"{lat.abs().max().item():.3g})")
    log(f"encode 512 px 'highest': {8 / t_hi:.2f} images/s (batch 8, first call), 'default': "
        f"{8 / t_def:.2f}; decode bf16 512 px, 50 steps, cfg 1.0: {t_dec / 2:.3f} s/image "
        f"(batch 2, first call) on {card}")
    del pipe
    release()
    return c3_


def k1024_path(card):
    """The K=1024 encode of measure_k1024 at batch 32, 'highest': one
    vq_argmax launch over 32 x 1024 = 32,768 rows, its ids against the
    plain run's by the 1e-6 margin rule."""
    from selftoktokenizer_tpu_torch.core.config import FLAGSHIP_CONFIG
    from selftoktokenizer_tpu_torch.tools import common
    from selftoktokenizer_tpu_torch.tools.measure_k1024 import k1024_config

    pipe = common.seeded_pipeline(k1024_config(FLAGSHIP_CONFIG), "cuda", datasize=256,
                                  encode_only=True, encode_precision="highest")
    images = common.uniform_images(32, 256, "cuda")
    pipe.encoding(images[:1])                     # warm-up outside the counted run
    reset_counts()
    ids, t = timed(lambda: pipe.encoding(images))
    c = counts()
    # one launch gave every id: it ran over all 32 x 1024 rows at once
    if c != (1, 0, 0, 0, 0, 0) or tuple(ids.shape) != (32, 1024):
        raise RuntimeError(f"K=1024: launch counts {c}, ids {tuple(ids.shape)}")
    before = counts()
    ids_p = pipe.encoding(images, kernels="plain")
    _, margins = pipe.encoding_margins(images, kernels="plain")
    torch.cuda.synchronize()
    if counts() != before:
        raise RuntimeError("kernels='plain' launched a kernel")
    check_ids_rule("K=1024 batch 32 'highest'", ids, ids_p, margins, VQ_MARGIN)
    log(f"  K=1024 batch 32 'highest': vq_argmax over N = {ids.numel()} rows in one launch, ids "
        f"differing from the plain run {int((ids != ids_p).sum())} (smallest margin "
        f"{margins.min().item():.3g}); {32 / t:.2f} images/s (first call) on {card}")
    del pipe
    release()
    return c


def remat_train_path(card):
    """bench_train's config at the flagship width (depth 24 x 1536), both
    trunks rematerialised, batch 8, fp32 with TF32 off: the first step held
    against the same step without remat (same weights and draws), its
    attention forward (48: each block's again in the backward) and backward
    (24) launches counted."""
    from selftoktokenizer_tpu_torch.core.config import FLAGSHIP_CONFIG, load_config
    from selftoktokenizer_tpu_torch.models import vq as vq_mod
    from selftoktokenizer_tpu_torch.models.tokenizer import tokenizer_config_from_params
    from selftoktokenizer_tpu_torch.tools import bench_train
    from selftoktokenizer_tpu_torch.train import trainer as tr

    depth, B = TOOLS_REMAT
    dev = "cuda"
    tcfg = bench_train.remat_config(
        tokenizer_config_from_params(dict(load_config(FLAGSHIP_CONFIG).tokenizer.params)), depth)
    check_train_widths(tcfg, renderer=False)
    plain_cfg = bench_train.without_remat(tcfg)
    tc = tr.TrainConfig(dit_lr=1e-5, token_lr=5e-5)
    prev = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
    try:
        torch.cuda.reset_peak_memory_stats()
        state = bench_train.seeded_state(tcfg, tc, dev)
        named = tr._trainable(state.model)
        batch = bench_train.latents(tcfg, B, dev)
        gen = torch.Generator(device=dev)
        gen.manual_seed(29)
        K, C = tcfg.k, tcfg.encoder.codebook_size
        draws = {"t": torch.rand((B,), generator=gen, device=dev),
                 "noise": torch.randn(batch.shape, generator=gen, device=dev),
                 "drop_ids": torch.arange(B, device=dev) % 4 == 1,
                 "kmeans_idx": vq_mod.kmeans_init_indices(B * K, C, gen),
                 "react_uniforms": torch.rand((C,), generator=gen, device=dev)}
        # the same step without remat: its gradients to the host
        loss_n, _, params = tr.tokenizer_grads(state, plain_cfg, batch, **draws)
        plain = [p.grad.detach().to("cpu", copy=True) for p in params]
        loss_n = float(loss_n.detach())
        peak_plain = torch.cuda.max_memory_allocated() / 2 ** 30
        torch.cuda.reset_peak_memory_stats()
        reset_counts()
        (state, logs), t = timed(lambda: tr.train_step(state, tcfg, tc, batch, **draws))
        c = counts()
        want = (0, 2 * depth, 0, 0, 2 * depth, depth)
        if c != want:
            raise RuntimeError(f"remat train step: launch counts {c}, expected {want}")
        loss = float(logs["loss"])
        hold_loss("remat train step 1", loss, loss_n, "the step without remat")
        hold_grads("remat train step 1", named, plain, "the step without remat")
        log(f"train tokenizer, both trunks rematerialised, depth {depth} x "
            f"{tcfg.decoder.hidden_size}, batch {B}, fp32 (TF32 off): step 1 {t:.3f} s, loss "
            f"{loss:.6f} (without remat {loss_n:.6f}), peak memory "
            f"{torch.cuda.max_memory_allocated() / 2 ** 30:.2f} GiB ({peak_plain:.2f} GiB for "
            f"the gradients without remat), attention launches {c[1]} forward, {c[5]} backward "
            f"on {card}")
        state.release()
        del state, named, params, plain
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = prev
    release()
    return c


def tools_phase(card, do_profile=False):
    """The measurement tools in process at short settings, each path counted
    from 0, and the holds of the paths they drive: the 512 px encode and
    decode, the K=1024 batch-32 encode, the rematerialised train step, the
    render loops, the data-parallel encode over one NCCL rank and the int8
    decode's q8_matmul launches."""
    import os
    import tempfile

    by_path = {}
    t_phase = time.time()
    by_path["512 px encode + bf16 decode"] = encode_decode_512_path(card)
    by_path["K=1024 batch 32 encode"] = k1024_path(card)
    by_path["remat train step, depth 24, batch 8"] = remat_train_path(card)

    line, c = run_tool("measure_k1024", ["--reps", "1", "--iters", "2"])
    by_path["tool measure_k1024"] = c
    if c[0] != 3 or line["vq_rows"] != 32768:
        raise RuntimeError(f"measure_k1024: {c} launches, {line['vq_rows']} rows")
    line, c = run_tool("bench_encode_serving", ["--iters", "2"])
    by_path["tool bench_encode_serving"] = c
    if c[0] < 1 or c[1] < 1:
        raise RuntimeError(f"bench_encode_serving launched {c}")
    _, c = run_tool("bench_encoder_bisect", ["--iters", "2"])
    by_path["tool bench_encoder_bisect"] = c
    for dt in ("bfloat16", "float32"):
        line, c = run_tool("bench_flash", ["--iters", "5", "--dtype", dt])
        by_path[f"tool bench_flash {dt}"] = c
        if c[1] != 7 * len(line["rows"]) or c[4] != (c[1] if dt == "float32" else 0):
            raise RuntimeError(f"bench_flash {dt}: launch counts {c}")
    line, c = run_tool("bench_decode512", ["--iters", "1"])
    by_path["tool bench_decode512"] = c
    v = line["variants"]
    if [r["attention_launches_per_decode"] for r in v.values()] != [24 * 50, 24 * 50, 0] \
            or v["serving_attention_false"]["max_abs_diff_vs_first"] != 0 \
            or v["plain_attention"]["max_abs_diff_vs_first"] > 1e-1:
        raise RuntimeError(f"bench_decode512: {v}")
    line, c = run_tool("bench_int8", ["--steps", "50", "--batch", "4", "--iters", "1"])
    by_path["tool bench_int8"] = c
    if line["q8_matmul_launches_per_int8_decode"] != 191 * 50 or c[2] != 2 * 191 * 50:
        raise RuntimeError(f"bench_int8: q8_matmul launches "
                           f"{line['q8_matmul_launches_per_int8_decode']} a decode, {c[2]} in all; "
                           f"expected 191 a cond call")
    line, c = run_tool("bench_render_overlap", ["--iters", "4"])
    by_path["tool bench_render_overlap"] = c
    if line["images_equal"] is not True:
        raise RuntimeError(f"bench_render_overlap: the loops' images differ "
                           f"{line['max_abs_diff_vs_fused']}")
    depth, B = TOOLS_REMAT
    line, c = run_tool("bench_train", ["--depth", str(depth), "--batch-size", str(B),
                                       "--iters", "1"])
    by_path["tool bench_train"] = c
    if line["hidden"] != 1536 or not math.isfinite(line["flash_loss"]) \
            or c[5] != 2 * depth or c[4] != 2 * 2 * depth:
        raise RuntimeError(f"bench_train: {line}, launches {c}")
    with tempfile.TemporaryDirectory() as d:
        line, c = run_tool("bench_scaling", ["--init-method", f"file://{os.path.join(d, 'store')}",
                                             "--batch-per-chip", "16", "--iters", "2"])
    by_path["tool bench_scaling N=1"] = c
    if line["backend"] != "nccl" or line["world"] != 1 or c[0] != 3:
        raise RuntimeError(f"bench_scaling: {line}, launches {c}")
    line, c = run_tool("bench_loader", ["--n", "64"])
    by_path["tool bench_loader"] = c
    if not line["native_available"] and not (line["native_unavailable_reason"]
                                             and line["native_loader_img_per_s"] is None
                                             and line["tar_decoder"] == "pil"):
        raise RuntimeError(f"bench_loader: an unavailable C++ loader's rows: {line}")
    log(f"  tools phase: {time.time() - t_phase:.1f} s on {card}")
    return by_path


def main_path_phase(card, do_profile=False):
    by_path = {}
    by_path["encode + bf16 decode"], ref = bf16_path(card, do_profile)
    by_path["int8 decode"] = int8_path(card, ref, do_profile)
    by_path["renderer bf16 + int8"] = renderer_path(card, ref)
    del ref
    release()
    log("phase zoo:")
    by_path.update(zoo_phase(card, do_profile))
    log("phase families:")
    by_path.update(families_phase(card, do_profile))
    log("phase corpus:")
    by_path.update(corpus_phase(card, do_profile))
    log("phase drivers:")
    by_path.update(drivers_phase(card, do_profile))
    log("phase train:")
    by_path.update(train_phase(card, do_profile))
    log("phase sharded:")
    by_path.update(sharded_phase(card, do_profile))
    log("phase tools:")
    by_path.update(tools_phase(card, do_profile))
    launches = {n: sum(c[i] for c in by_path.values()) for i, n in enumerate(KERNEL_NAMES)}
    by_path = {p: dict(zip(KERNEL_NAMES, c)) for p, c in by_path.items()}
    log(f"  launches on the main paths: {json.dumps(by_path)}")
    return launches, by_path


# ------------------------------------------------------------------ main ---

def main():
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--only", choices=["kernels", "train", "zoo", "families", "corpus",
                                        "drivers", "sharded", "tools"],
                    default=None,
                    help="stop after the kernel phase, or run the train, the zoo, the "
                         "families, the corpus, the drivers, the sharded or the tools "
                         "phase alone")
    ap.add_argument("--ptxas", action="store_true",
                    help="print the compiler's per-kernel resource report")
    ap.add_argument("--profile", action="store_true",
                    help="also profile one warm bf16 and one warm int8 decode: "
                         "device time by kernel, busy share; the train steps; "
                         "the zoo's two forms of a CFG sampler step")
    ap.add_argument("--q8-sweep", action="store_true",
                    help="also time every q8_matmul plan (tile width, K splits) "
                         "at the main path's shapes")
    args = ap.parse_args()
    t_start = time.time()

    # phase 1: device
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device available", file=sys.stderr)
        return 1
    card = card_line()
    kind = torch.cuda.get_device_name(0)
    log(f"phase device: {kind}; torch {torch.__version__}, cuda {torch.version.cuda}")

    # phase 2: build
    from selftoktokenizer_tpu_torch.ops import _build

    t0 = time.time()
    _build.build_all(verbose=args.ptxas)
    log(f"phase build: {len(_build.KERNEL_SOURCES)} kernels built in {time.time() - t0:.1f} s")

    if args.only in ("train", "zoo", "families", "corpus", "drivers", "sharded", "tools"):
        log(f"phase {args.only}:")
        phase = {"train": train_phase, "zoo": zoo_phase, "families": families_phase,
                 "corpus": corpus_phase, "drivers": drivers_phase,
                 "sharded": sharded_phase, "tools": tools_phase}[args.only]
        paths = phase(card, args.profile)
        by_path = {p: dict(zip(KERNEL_NAMES, c)) for p, c in paths.items()}
        log(f"  launches on the {args.only} paths: {json.dumps(by_path)}")
        log(card)
        log(f"chip_smoke: stopped after phase {args.only} ({time.time() - t_start:.1f} s)")
        return 0

    # phase 3: kernels against their plain versions
    log("phase kernels:")
    attn_recs, attn_grad_recs, vq_recs, q8_recs, conv_recs = kernel_phase()
    if args.q8_sweep:
        from selftoktokenizer_tpu_torch.ops import q8_matmul as q8
        q8_sweep(q8)
    launches = dict.fromkeys(KERNEL_NAMES, 0)
    by_path = {}

    # phase 4: the main paths at full width
    if args.only is None:
        log("phase main path:")
        launches, by_path = main_path_phase(card, args.profile)

    def launches_of(name, c):
        # the bf16 forward's launches: every forward launch but the fp32 ones
        if name == "flash_sdpa_key_mask":
            return c[name] - c["flash_sdpa_key_mask_fp32"]
        return c[name]

    def headline(name, recs, source, replaces, **extra):
        h = recs[0]   # the main path's first shape
        return {"name": name, "route": "cuda", "source": source, "replaces": replaces,
                "launches": launches_of(name, launches),
                "launches_by_path": {p: launches_of(name, c) for p, c in by_path.items()},
                "max_abs_err": max(r["max_abs_err"] for r in recs),
                "ms": h["ms"], "plain_ms": h["plain_ms"], "bound_ms": h["bound_ms"],
                "bound_by": h["bound_by"], "library_ms": h["library_ms"],
                "shape": h["shape"], **extra, "cases": recs}

    src = "selftoktokenizer_tpu_torch/csrc/"
    fp32_head = next(r for r in attn_recs if r["case"] == "train_joint_fp32_masked")
    kernels = [
        headline("vq_argmax", vq_recs, src + "vq_argmax.cu",
                 "selftoktokenizer_tpu/ops/vq_kernels.py:86", share=vq_recs[0]["share"],
                 rescored_mean=vq_recs[0]["rescored_mean"], rescored_max=vq_recs[0]["rescored_max"]),
        headline("flash_sdpa_key_mask", [r for r in attn_recs if r["dtype"] == "bfloat16"],
                 src + "flash_attention.cu", "selftoktokenizer_tpu/ops/flash_attention.py:102",
                 share=attn_recs[0]["share"]),
        # the fp32 forward: the tokenizer's training shape first
        headline("flash_sdpa_key_mask_fp32",
                 sorted((r for r in attn_recs if r["dtype"] == "float32"),
                        key=lambda r: r["case"] != "train_joint_fp32_masked"),
                 src + "flash_attention_tf32.cu", "selftoktokenizer_tpu/ops/flash_attention.py:102",
                 share=fp32_head["share"],
                 fp32_cuda_core_bound_ms=fp32_head["fp32_cuda_core_bound_ms"],
                 fp32_cuda_core_share=fp32_head["fp32_cuda_core_share"]),
        # the backward of the reference's custom VJP (an XLA recompute there)
        headline("flash_sdpa_key_mask_backward", attn_grad_recs, src + "flash_attention_tf32.cu",
                 "selftoktokenizer_tpu/ops/flash_attention.py:147",
                 share=attn_grad_recs[0]["share"],
                 fp32_cuda_core_bound_ms=attn_grad_recs[0]["fp32_cuda_core_bound_ms"],
                 fp32_cuda_core_share=attn_grad_recs[0]["fp32_cuda_core_share"]),
        headline("q8_matmul", q8_recs, src + "q8_matmul.cu",
                 "selftoktokenizer_tpu/ops/q8_matmul.py:75",
                 quantize_ms=q8_recs[0]["quantize_ms"]),
        # no path runs it, in the JAX package either: held here, wired nowhere
        headline("conv3ch_3x3", conv_recs, src + "conv3ch.cu",
                 "selftoktokenizer_tpu/ops/conv3ch.py:69", wired=False, share=conv_recs[0]["share"]),
    ]
    if args.only is not None:
        log(json.dumps({"kernels": kernels}))
        log(card)
        log(f"chip_smoke: stopped after phase {args.only} ({time.time() - t_start:.1f} s)")
        return 0
    for kr in kernels:
        if kr.get("wired", True) and kr["launches"] < 1:
            raise RuntimeError(f"the main path never launched {kr['name']}")
    if launches["conv3ch_3x3"] != 0:
        raise RuntimeError("conv3ch_3x3 is wired into nothing, yet the main path launched it")
    log(f"chip_smoke: all phases passed in {time.time() - t_start:.1f} s")
    log(json.dumps({"kernels": kernels}))
    log(card)
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
