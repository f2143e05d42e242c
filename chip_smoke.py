"""Chip smoke test of the PyTorch / CUDA port: builds the CUDA kernels,
holds each against its plain PyTorch version on the GPU, and drives the
flagship encode + 50-step decode path at full width on seeded random
weights.

Run with no arguments on a machine with one NVIDIA GPU (sm_90a) and the
CUDA toolkit:

    python3 chip_smoke.py

It exits non-zero when no GPU is available or when any phase fails. The
last line of its standard output is one JSON object
``{"ok": true, "device": {...}}``; the line before the card line is one
JSON object ``{"kernels": [...]}`` with each kernel's error, times and bound.
``--only kernels`` stops after the kernel phase; ``--ptxas`` prints the
compiler's register and shared-memory report; ``--profile`` adds a
torch.profiler pass over one warm decode.
"""

from __future__ import annotations

import argparse
import json
import math
import subprocess
import sys
import time

import torch

# published peaks of one H100 SXM (dense): the roofline the bounds are stated against
PEAK_BF16_FLOPS = 989e12
PEAK_FP32_FLOPS = 67e12
PEAK_BYTES = 3.35e12

ATTN_TOL = {torch.bfloat16: 2e-2, torch.float32: 2e-5}
VQ_MARGIN = 1e-6          # ids may differ from the plain version only below this top-2 margin
DEFAULT_TIER_MARGIN = 0.05  # bf16 trunk: kernel and plain ids may differ only below this margin
LATENT_TOL = 5e-2         # bf16 decode, kernels against forced plain versions


def log(msg):
    print(msg, flush=True)


def card_line():
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60)
    if out.returncode != 0:
        raise RuntimeError(f"nvidia-smi failed: {out.stderr}")
    return out.stdout.strip().splitlines()[0].strip()


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

def attn_bound(B, H, Lq, Lk, D, dtype, masked):
    flops = 4.0 * B * H * Lq * Lk * D
    item = 2 if dtype == torch.bfloat16 else 4
    nbytes = (2 * Lq + 2 * Lk) * D * B * H * item + (B * Lk if masked else 0)
    t_ops = flops / (PEAK_BF16_FLOPS if dtype == torch.bfloat16 else PEAK_FP32_FLOPS)
    t_bytes = nbytes / PEAK_BYTES
    return max(t_ops, t_bytes) * 1e3, "operations" if t_ops >= t_bytes else "bytes"


def vq_bound(N, C, D=16):
    t_ops = 2.0 * N * C * D / PEAK_FP32_FLOPS
    t_bytes = (N * D * 4 + C * D * 4 + N * 4) / PEAK_BYTES
    return max(t_ops, t_bytes) * 1e3, "operations" if t_ops >= t_bytes else "bytes"


def attn_case(fa, name, B, H, Lq, Lk, D, dtype, mask_kind, gen, timed):
    import torch.nn.functional as F

    dev = "cuda"
    q = torch.randn((B, H, Lq, D), generator=gen, device=dev, dtype=torch.float32).to(dtype)
    k = torch.randn((B, H, Lk, D), generator=gen, device=dev, dtype=torch.float32).to(dtype)
    v = torch.randn((B, H, Lk, D), generator=gen, device=dev, dtype=torch.float32).to(dtype)
    mask = None
    if mask_kind == "prefix":
        # the decode path's masks: a prefix of the context keys active, all x keys active
        n_ctx = Lk - 256 if Lk > 256 else Lk // 2
        active = torch.randint(1, n_ctx + 1, (B,), generator=gen, device=dev)
        pos = torch.arange(Lk, device=dev)[None, :]
        mask = (pos < active[:, None]) | (pos >= n_ctx)
    elif mask_kind == "random":
        mask = torch.rand((B, Lk), generator=gen, device=dev) > 0.5
        mask[:, 0] = True
    elif mask_kind == "full_row":
        mask = torch.rand((B, Lk), generator=gen, device=dev) > 0.5
        mask[0, :] = False            # batch 0: every key masked -> uniform mean
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
    if mask_kind == "full_row":
        uni = v[0].float().mean(dim=1, keepdim=True).expand(-1, Lq, -1)
        uerr = (out[0].float() - uni).abs().max().item()
        if uerr > tol:
            raise RuntimeError(f"{name}: fully masked row is not the uniform mean ({uerr})")
    if err > tol:
        raise RuntimeError(f"{name}: kernel differs from the plain version by {err} > {tol}")
    rec = {"case": name, "shape": [B, H, Lq, Lk, D], "dtype": str(dtype).replace("torch.", ""),
           "mask": mask_kind, "max_abs_err": err, "tol": tol}
    if timed:
        bound, by = attn_bound(B, H, Lq, Lk, D, dtype, mask is not None)
        am = None if mask is None else mask[:, None, None, :]
        rec.update(
            ms=time_ms(lambda: fa.flash_sdpa_key_mask(q, k, v, mask)),
            host_paced_ms=time_ms(lambda: fa.flash_sdpa_key_mask(q, k, v, mask), hold=False),
            plain_ms=time_ms(lambda: fa.flash_sdpa_key_mask_plain(q, k, v, mask), reps=3, rounds=3),
            library_ms=time_ms(lambda: F.scaled_dot_product_attention(q, k, v, attn_mask=am)),
            bound_ms=bound, bound_by=by)
    log(f"  attention {name}: {json.dumps(rec)}")
    return rec


def vq_case(vk, name, N, C, gen, timed, kind="random"):
    dev = "cuda"
    z = torch.randn((N, 16), generator=gen, device=dev)
    z = z / z.norm(dim=-1, keepdim=True)
    e = torch.randn((C, 16), generator=gen, device=dev)
    e = e / e.norm(dim=-1, keepdim=True)
    if kind == "identical":
        e = e[:1].expand(C, 16).contiguous()          # every code equal -> id 0
    elif kind == "duplicates":
        # every code appears twice more, later in the book: the lowest index must win
        third = C // 3
        e = torch.cat([e[:third], e[:third], e[:third]]).contiguous()
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
        margin = (top2[:, 0] - top2[:, 1])
        bad = (ids != plain) & (margin >= VQ_MARGIN)
        if int(bad.sum()) != 0:
            raise RuntimeError(
                f"{name}: {int(bad.sum())} ids differ from the plain version outside margin {VQ_MARGIN}")
    rec = {"case": name, "shape": [N, C, 16], "kind": kind, "max_abs_err": err}
    if timed:
        bound, by = vq_bound(N, C)
        rec.update(
            ms=time_ms(lambda: vk.vq_argmax(z, e)),
            host_paced_ms=time_ms(lambda: vk.vq_argmax(z, e), hold=False),
            plain_ms=time_ms(lambda: vk.vq_argmax_plain(z, e)),
            library_ms=time_ms(lambda: torch.argmax(z @ e.t(), dim=-1)),
            bound_ms=bound, bound_by=by)
    log(f"  vq_argmax {name}: {json.dumps(rec)}")
    return rec


def kernel_phase():
    from selftoktokenizer_tpu_torch.ops import flash_attention as fa
    from selftoktokenizer_tpu_torch.ops import vq_kernels as vk

    gen = torch.Generator(device="cuda")
    gen.manual_seed(1234)
    bf, f32 = torch.bfloat16, torch.float32
    attn = [
        # (name, B, H, Lq, Lk, D, dtype, mask, timed): the main path's shapes first
        ("decode_joint_bf16_masked", 2, 24, 768, 768, 64, bf, "prefix", True),
        ("encoder_query_bf16", 8, 8, 512, 768, 64, bf, None, True),
        ("decode_uncond_bf16", 2, 24, 256, 256, 64, bf, None, True),
        ("decode_joint_fp32_masked", 2, 24, 768, 768, 64, f32, "prefix", True),
        ("ragged_bf16", 2, 3, 200, 333, 64, bf, "random", False),
        ("ragged_fp32", 2, 3, 200, 333, 64, f32, "random", False),
        ("fully_masked_row_bf16", 2, 4, 128, 192, 64, bf, "full_row", False),
        ("fully_masked_row_fp32", 2, 4, 128, 192, 64, f32, "full_row", False),
        ("head_dim_128_bf16", 1, 4, 130, 257, 128, bf, "random", False),
        ("head_dim_128_fp32", 1, 4, 130, 257, 128, f32, "random", False),
    ]
    attn_recs = [attn_case(fa, *c[:8], gen, c[8]) for c in attn]
    vq = [
        ("flagship_b8", 4096, 32768, True, "random"),
        ("flagship_b32", 16384, 32768, True, "random"),
        ("ragged", 1000, 5001, False, "random"),
        ("identical_codes", 300, 4096, False, "identical"),
        ("duplicate_codes", 777, 3 * 1024, False, "duplicates"),
    ]
    vq_recs = [vq_case(vk, n, N, C, gen, timed, kind) for n, N, C, timed, kind in vq]
    return attn_recs, vq_recs


# ------------------------------------------------------------- main path ---

def profile_decode(pipe, ids, noise, warm_s):
    """Device time by kernel over one warm bf16 decode (torch.profiler), and
    the device's busy share of the un-profiled warm wall time."""
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
    log(f"  profile of one warm decode (batch {ids.shape[0]}, 50 steps): device busy "
        f"{total / 1e6:.3f} s of {warm_s:.3f} s wall = {total / 1e6 / warm_s:.3f}; "
        f"{sum(r[1] for r in rows)} device kernels")
    for us, n, key in rows[:12]:
        log(f"    {us / 1e3:9.2f} ms {us / total:6.3f} x{n:<6d} {key[:110]}")


def main_path_phase(card, do_profile=False):
    from selftoktokenizer_tpu_torch.core.config import FLAGSHIP_CONFIG, load_config
    from selftoktokenizer_tpu_torch.ops import flash_attention as fa
    from selftoktokenizer_tpu_torch.ops import vq_kernels as vk
    from selftoktokenizer_tpu_torch.pipeline import SelftokPipeline

    cfg = load_config(FLAGSHIP_CONFIG)
    t0 = time.time()
    # non-zero adaLN and biases: the reference init zeroes every attention gate,
    # which would hide a wrong attention kernel from every end-to-end check
    pipe = SelftokPipeline(cfg, datasize=256, steps=50, decode_dtype=torch.bfloat16,
                           encode_precision="highest", seed=0, zero_init_std=0.02)
    torch.cuda.synchronize()
    n_params = sum(p.numel() for m in (pipe.encoder, pipe.model, pipe.vae)
                   for p in m.parameters())
    log(f"  pipeline built in {time.time() - t0:.1f} s: {n_params / 1e9:.2f} B parameters, "
        f"{torch.cuda.max_memory_allocated() / 2**30:.1f} GiB peak")
    enc_cfg, dec_cfg = pipe.tcfg.encoder, pipe.tcfg.decoder
    widths = (enc_cfg.depth, enc_cfg.query_dim, enc_cfg.K, enc_cfg.codebook_size,
              dec_cfg.depth, dec_cfg.hidden_size, dec_cfg.num_heads)
    if widths != (16, 512, 512, 32768, 24, 1536, 24):
        raise RuntimeError(f"not the flagship widths: {widths}")

    gen = torch.Generator(device="cuda")
    gen.manual_seed(7)
    images = torch.rand((8, 256, 256, 3), generator=gen, device="cuda") * 2 - 1
    noise2 = torch.randn((2, 32, 32, 16), generator=gen, device="cuda")
    noise1 = noise2[:1].clone()
    B, K, depth, steps = 8, 512, dec_cfg.depth, 50

    def timed(fn):
        torch.cuda.synchronize()
        t = time.time()
        out = fn()
        torch.cuda.synchronize()
        return out, time.time() - t

    def counts():
        return vk.launch_count, fa.launch_count

    def check_ids(ids, b):
        if ids.dtype != torch.int32 or tuple(ids.shape) != (b, K) \
                or int(ids.min()) < 0 or int(ids.max()) >= 32768:
            raise RuntimeError(f"bad token ids: {ids.dtype} {tuple(ids.shape)}")

    def check_images(img, b):
        if tuple(img.shape) != (b, 256, 256, 3) or not torch.isfinite(img).all() \
                or float(img.min()) < 0 or float(img.max()) > 1:
            raise RuntimeError(f"bad images: {tuple(img.shape)}")

    # warm-up outside the counted run (cuDNN autotune, cuBLAS handles)
    pipe.encoding(images[:1])

    # ---- the counted run: every count set to 0 just before, read just after
    vk.launch_count = 0
    fa.launch_count = 0
    ids_hi, t_hi = timed(lambda: pipe.encoding(images))
    c1 = counts()
    ids_def, t_def = timed(lambda: pipe.encoding(images, precision="default"))
    c2 = counts()
    (img2, lat2), t_dec = timed(lambda: pipe.decoding(
        ids_hi[:2], noise=noise2, cfg_scale=1.0, return_latents=True))
    c3 = counts()
    (img1, lat1), t_cfg = timed(lambda: pipe.decoding(
        ids_hi[:1], noise=noise1, cfg_scale=2.0, return_latents=True))
    c4 = counts()
    launches = {"vq_argmax": c4[0], "flash_sdpa_key_mask": c4[1]}

    expect = [(1, 0), (2, enc_cfg.depth), (2, enc_cfg.depth + depth * steps),
              (2, enc_cfg.depth + 3 * depth * steps)]
    if [c1, c2, c3, c4] != expect:
        raise RuntimeError(f"launch counts {[c1, c2, c3, c4]} differ from the path's {expect}")
    log(f"  launches on the main path: {json.dumps(launches)}")
    check_ids(ids_hi, B)
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
    diff_def = ids_def != ids_def_p
    if int((diff_def & (margins >= DEFAULT_TIER_MARGIN)).sum()) != 0:
        raise RuntimeError("'default' encode: kernel ids differ from plain ids outside the margin")
    agree_def = 1.0 - diff_def.float().mean().item()
    if agree_def < 0.5:
        raise RuntimeError(f"'default' encode: only {agree_def:.3f} of ids agree with the plain path")
    e2 = (lat2 - lat2_p).abs().max().item()
    e1 = (lat1 - lat1_p).abs().max().item()
    log(f"  kernels vs forced plain: 'highest' ids differing {int(diff_hi.sum())}/{diff_hi.numel()}, "
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
    def warm(fn, n):
        ts = sorted(timed(fn)[1] for _ in range(n))
        return ts[len(ts) // 2]

    w_hi = warm(lambda: pipe.encoding(images), 3)
    w_def = warm(lambda: pipe.encoding(images, precision="default"), 3)
    w_dec = warm(lambda: pipe.decoding(ids_hi[:2], noise=noise2, cfg_scale=1.0), 2)
    w_cfg = warm(lambda: pipe.decoding(ids_hi[:1], noise=noise1, cfg_scale=2.0), 1)
    log(f"encode 'highest': {B / w_hi:.2f} images/s (batch {B}, {w_hi * 1e3:.1f} ms warm, "
        f"{t_hi * 1e3:.1f} ms first call) on {card}")
    log(f"encode 'default': {B / w_def:.2f} images/s (batch {B}, {w_def * 1e3:.1f} ms warm, "
        f"{t_def * 1e3:.1f} ms first call) on {card}")
    log(f"decode bf16, 50 steps, cfg 1.0: {w_dec / 2:.3f} s/image (batch 2, {w_dec:.3f} s warm, "
        f"{t_dec:.3f} s first call) on {card}")
    log(f"decode bf16, 50 steps, cfg 2.0: {w_cfg:.3f} s/image (batch 1, warm; "
        f"{t_cfg:.3f} s first call) on {card}")
    if do_profile:
        profile_decode(pipe, ids_hi[:2], noise2, w_dec)
    return launches


# ------------------------------------------------------------------ main ---

def main():
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--only", choices=["kernels"], default=None,
                    help="stop after the kernel phase")
    ap.add_argument("--ptxas", action="store_true",
                    help="print the compiler's per-kernel resource report")
    ap.add_argument("--profile", action="store_true",
                    help="also profile one warm decode: device time by kernel, busy share")
    args = ap.parse_args()

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

    # phase 3: kernels against their plain versions
    log("phase kernels:")
    attn_recs, vq_recs = kernel_phase()
    launches = {"vq_argmax": 0, "flash_sdpa_key_mask": 0}

    # phase 4: the main path at full width
    if args.only is None:
        log("phase main path:")
        launches = main_path_phase(card, args.profile)

    def headline(name, recs, source, replaces):
        h = recs[0]   # the main path's first shape
        return {"name": name, "route": "cuda", "source": source, "replaces": replaces,
                "launches": launches[name],
                "max_abs_err": max(r["max_abs_err"] for r in recs),
                "ms": h["ms"], "plain_ms": h["plain_ms"], "bound_ms": h["bound_ms"],
                "bound_by": h["bound_by"], "library_ms": h["library_ms"],
                "shape": h["shape"], "cases": recs}

    kernels = [
        headline("vq_argmax", vq_recs, "selftoktokenizer_tpu_torch/csrc/vq_argmax.cu",
                 "selftoktokenizer_tpu/ops/vq_kernels.py:86"),
        headline("flash_sdpa_key_mask", attn_recs,
                 "selftoktokenizer_tpu_torch/csrc/flash_attention.cu",
                 "selftoktokenizer_tpu/ops/flash_attention.py:102"),
    ]
    if args.only is not None:
        log(json.dumps({"kernels": kernels}))
        log(card)
        log(f"chip_smoke: stopped after phase {args.only}")
        return 0
    for kr in kernels:
        if kr["launches"] < 1:
            raise RuntimeError(f"the main path never launched {kr['name']}")
    log(json.dumps({"kernels": kernels}))
    log(card)
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
