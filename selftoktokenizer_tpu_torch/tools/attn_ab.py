"""A/B of the split-TF32 attention kernels (``csrc/flash_attention_tf32.cu``):
builds of the source with one part cut out or done another way, each timed
in turns with the source as it is, and each one's error at large scores.

    python -m selftoktokenizer_tpu_torch.tools.attn_ab [--only NAME ...]

Needs one NVIDIA GPU (sm_90a) and ``nvcc``. Every variant is built in
parallel into ``build/attn_ab/<name>/`` (ignored by git). Times: the fp32
forward (with row statistics) and the backward at the tokenizer's joint
attention and the renderer's context rows, median CUDA-event time with the
stream parked behind a spin so that only device time is bracketed; the
backward's two kernels apart (torch.profiler). A cut that takes work away
gives wrong outputs: its time is the point. Errors, on inputs whose
scores reach about 30 (q and k of std 2.5, D 64 and 128): the forward
against the plain version (fp32, TF32 off) and against float64, the
gradients against float64 autograd (each relative to its gradient's
largest value), the largest over 4 draws. One JSON line a variant, then the card's name and power
limit.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import math
import os
import shutil
import subprocess

import torch

from selftoktokenizer_tpu_torch.ops import _build
from selftoktokenizer_tpu_torch.ops import flash_attention as fa

HOLD_CYCLES = 40_000_000    # about 20 ms of device spin at the H100's clock
DRAWS = 4                   # seeded draws of the large-score inputs at each head dim

# the forward's two products accumulated in place, as the backward's are:
# S = Q K^T without a fresh accumulator for each k8 step, and P V straight
# into O (the tensor core truncates what it adds to its accumulator)
S_IN_PLACE = [("mma_rows<float, D, true, true, true>(sc", "mma_rows<float, D, true, true, false>(sc")]
O_IN_PLACE = [(
    "#pragma unroll\n"
    "        for (int j0 = 0; j0 < D / 8; j0 += 4) {\n"
    "            float pv[4][4];\n"
    "            zero(pv);\n"
    "            mma_regs<float, D, true>(pv, sc, kt + S::TILE, g, t, j0);\n"
    "#pragma unroll\n"
    "            for (int jd = 0; jd < 4; ++jd) {\n"
    "                o[j0 + jd][0] = fmaf(o[j0 + jd][0], alpha[0], pv[jd][0]);\n"
    "                o[j0 + jd][1] = fmaf(o[j0 + jd][1], alpha[0], pv[jd][1]);\n"
    "                o[j0 + jd][2] = fmaf(o[j0 + jd][2], alpha[1], pv[jd][2]);\n"
    "                o[j0 + jd][3] = fmaf(o[j0 + jd][3], alpha[1], pv[jd][3]);\n"
    "            }\n"
    "        }\n",
    "#pragma unroll\n"
    "        for (int jd = 0; jd < D / 8; ++jd) {\n"
    "            o[jd][0] *= alpha[0];\n"
    "            o[jd][1] *= alpha[0];\n"
    "            o[jd][2] *= alpha[1];\n"
    "            o[jd][3] *= alpha[1];\n"
    "        }\n"
    "        mma_regs<float, D, true>(o, sc, kt + S::TILE, g, t);\n")]

# (name, what it changes, [(text of the source, its replacement)])
VARIANTS = [
    ("base", "nothing", []),
    ("hi_only", "cuts the lo passes: one TF32 product (hi * hi) a product", [(
        "    if constexpr (ALO) mma(d, al, bh0, bh1);\n"
        "    if constexpr (BLO) mma(d, ah, bl0, bl1);\n", "")]),
    ("no_split", "cuts the rounding into hi and lo (add, and, sub a value)", [(
        "        hi = (__float_as_uint(x) + 0x1000u) & 0xffffe000u;\n"
        "        lo = __float_as_uint(x - __uint_as_float(hi));\n",
        "        hi = __float_as_uint(x);\n        lo = hi;\n")]),
    ("cvt_split", "splits by cvt.rna.tf32.f32 for hi and for lo, in place of the integer "
                  "rounding of hi and the truncated lo", [(
        "        hi = (__float_as_uint(x) + 0x1000u) & 0xffffe000u;\n"
        "        lo = __float_as_uint(x - __uint_as_float(hi));\n",
        '        asm("cvt.rna.tf32.f32 %0, %1;\\n" : "=r"(hi) : "f"(x));\n'
        '        asm("cvt.rna.tf32.f32 %0, %1;\\n" : "=r"(lo) : "f"(x - __uint_as_float(hi)));\n')]),
    ("no_exp", "cuts the exponentials", [(
        'asm("ex2.approx.ftz.f32 %0, %1;\\n" : "=f"(y) : "f"(x));', "y = x;")]),
    ("dkdv_one_block", "gives the dK / dV pass one block an SM (255 registers)", [(
        "__launch_bounds__(THREADS, D == 64 ? 2 : 1)\nflash_bwd_dkdv_kernel",
        "__launch_bounds__(THREADS, 1)\nflash_bwd_dkdv_kernel")]),
    ("s_in_place", "accumulates the forward's S = Q K^T in place", S_IN_PLACE),
    ("o_in_place", "accumulates the forward's P V straight into O", O_IN_PLACE),
    ("both_in_place", "both: the forward as the backward accumulates", S_IN_PLACE + O_IN_PLACE),
]


def time_ms(fn, reps=10, rounds=5):
    """Median over rounds of the CUDA-event time of `reps` calls / reps,
    the host's enqueueing hidden behind a spin kernel."""
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(rounds):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(HOLD_CYCLES)
        start.record()
        for _ in range(reps):
            fn()
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end) / reps)
    return sorted(times)[len(times) // 2]


def build(variants):
    """{name: (ctypes library, ptxas report)}, every build in parallel."""
    src = os.path.join(_build.CSRC_DIR, "flash_attention_tf32.cu")
    text = open(src).read()
    procs = []
    for name, _, cuts in variants:
        d = os.path.join(_build.BUILD_DIR, "attn_ab", name)
        os.makedirs(d, exist_ok=True)
        body = text
        for old, new in cuts:
            if body.count(old) != 1:
                raise RuntimeError(f"{name}: the source does not hold {old!r} once")
            body = body.replace(old, new)
        with open(os.path.join(d, "flash_attention_tf32.cu"), "w") as f:
            f.write(body)
        shutil.copy(os.path.join(_build.CSRC_DIR, "hopper.cuh"), d)
        out = os.path.join(d, "lib.so")
        procs.append((name, out, subprocess.Popen(
            [_build._nvcc(), *_build.NVCC_FLAGS, "-Xptxas", "-v", "-o", out,
             os.path.join(d, "flash_attention_tf32.cu")],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)))
    libs = {}
    for name, out, proc in procs:
        report, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"{name}: nvcc failed:\n{report}")
        regs = [line.split(": ", 1)[-1].strip() for line in report.splitlines()
                if "Compiling entry" in line or "registers" in line or "spill" in line]
        libs[name] = (ctypes.CDLL(out), regs)
    return libs


def large_score_inputs(D, gen):
    """q, k of std 2.5 (scores q.k / sqrt(D) of std 6.25, the largest about
    30), v and the output gradient of std 1; [2, 4, 300, D] fp32."""
    q, k = (torch.randn((2, 4, 300, D), generator=gen, device="cuda") * 2.5 for _ in range(2))
    v, do = (torch.randn((2, 4, 300, D), generator=gen, device="cuda") for _ in range(2))
    return q, k, v, do


def float64_reference(q, k, v, do):
    """Output and (dq, dk, dv) in float64 autograd."""
    q64, k64, v64 = (t.double().requires_grad_() for t in (q, k, v))
    w = torch.softmax(q64 @ k64.transpose(-1, -2) / math.sqrt(q.shape[-1]), dim=-1)
    out = w @ v64
    return out.detach(), torch.autograd.grad(out, (q64, k64, v64), do.double())


def errors(inputs):
    """The kernels' errors at large scores (see the module's docstring), the
    largest over the draws."""
    res = {}
    for D, draws in inputs.items():
        row = {}
        for q, k, v, do, ref_o, ref_g in draws:
            o, stats = fa._launch(q, k, v, None, stats=True)
            grads = fa.flash_sdpa_key_mask_backward(q, k, v, None, o, do, stats)
            plain = fa.flash_sdpa_key_mask_plain(q, k, v)
            errs = {
                "max_abs_score": float((q @ k.transpose(-1, -2)).abs().max()) / math.sqrt(D),
                "forward_vs_plain": float((o - plain).abs().max()),
                "forward_vs_float64": float((o.double() - ref_o).abs().max()),
                "plain_vs_float64": float((plain.double() - ref_o).abs().max()),
                **{f"d{n}_vs_float64": float((g.double() - r).abs().max() / r.abs().max())
                   for n, g, r in zip("qkv", grads, ref_g)}}
            row = {key: max(val, row.get(key, val)) for key, val in errs.items()}
        res[f"D{D}"] = row
    return res


def main(argv=None):
    ap = argparse.ArgumentParser("attn_ab", description=__doc__)
    ap.add_argument("--only", nargs="*", default=None, help="variants to build besides base")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("attn_ab: needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    variants = [v for v in VARIANTS if args.only is None or v[0] == "base" or v[0] in args.only]
    libs = build(variants)
    gen = torch.Generator(device="cuda")
    gen.manual_seed(77)
    inputs = {D: [] for D in (64, 128)}
    for D in inputs:
        for _ in range(DRAWS):
            q, k, v, do = large_score_inputs(D, gen)
            inputs[D].append((q, k, v, do, *float64_reference(q, k, v, do)))
    cases = []
    for case, B, H, Lq, Lk, kind in (("tokenizer joint", 4, 24, 768, 768, "prefix"),
                                      ("renderer context rows", 4, 24, 512, 512, "ones")):
        q, k, v, do = (torch.randn((B, H, L, 64), generator=gen, device="cuda")
                       for L in (Lq, Lk, Lk, Lq))
        pos = torch.arange(Lk, device="cuda")[None, :]
        if kind == "prefix":
            active = torch.randint(1, Lk - 256 + 1, (B,), generator=gen, device="cuda")
            mask = (pos < active[:, None]) | (pos >= Lk - 256)
        else:
            mask = torch.ones((B, Lk), dtype=torch.bool, device="cuda")
        cases.append((f"{case} [{B}, {H}, {Lq}, {Lk}, 64] fp32, {kind} mask", q, k, v, do, mask))
    saved = _build._libs.get("flash_attention_tf32")
    rows = {name: {"changes": what, "ptxas": libs[name][1], "times": {}} for name, what, _ in variants}
    try:
        # in turns: every variant, then base again
        for name in [n for n, _, _ in variants] + ["base"]:
            _build._libs["flash_attention_tf32"] = libs[name][0]
            for label, q, k, v, do, mask in cases:
                o, stats = fa._launch(q, k, v, mask, stats=True)
                rows[name]["times"].setdefault(label, []).append({
                    "forward_ms": time_ms(lambda: fa._launch(q, k, v, mask, stats=True)),
                    "backward_ms": time_ms(
                        lambda: fa.flash_sdpa_key_mask_backward(q, k, v, mask, o, do, stats))})
            rows[name].setdefault("large_scores", errors(inputs))
        from torch.autograd import DeviceType
        from torch.profiler import ProfilerActivity, profile

        _build._libs["flash_attention_tf32"] = libs["base"][0]
        for label, q, k, v, do, mask in cases:
            o, stats = fa._launch(q, k, v, mask, stats=True)
            with profile(activities=[ProfilerActivity.CUDA]) as prof:
                for _ in range(10):
                    fa.flash_sdpa_key_mask_backward(q, k, v, mask, o, do, stats)
                torch.cuda.synchronize()
            rows["base"].setdefault("backward_kernels_ms", {})[label] = {
                e.key.split("<")[0].split()[-1]:
                    (getattr(e, "self_device_time_total", 0) or e.self_cuda_time_total) / e.count / 1e3
                for e in prof.key_averages()
                if e.device_type == DeviceType.CUDA and "flash_bwd" in e.key}
    finally:
        if saved is None:
            _build._libs.pop("flash_attention_tf32", None)
        else:
            _build._libs["flash_attention_tf32"] = saved
    for name, row in rows.items():
        print(json.dumps({"variant": name, **row}), flush=True)
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True).stdout.strip()
    print(card, flush=True)
    return rows


if __name__ == "__main__":
    main()
