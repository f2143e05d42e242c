"""Component bisect of the flagship Qformer encoder's dual trunk
(counterpart of the reference ``tools/bench_encoder_bisect.py``).

    python -m selftoktokenizer_tpu_torch.tools.bench_encoder_bisect \\
        [--prec default|high|highest] [--batch 32] [--k 512|1024] [--device cuda]

Method: time the whole trunk at serving numerics (bf16 activations, batch
32), then variants with ONE component removed each; the difference is that
component's cost in context. Timing-proxy caveat, as in the reference:
this file rebuilds the dual block from the port's ops
(``models/encoder.py::dual_block_apply`` and ``dual_attention_apply``:
``linear``, ``layer_norm``, ``modulate``, ``gate``, ``mlp_apply``, plain
``sdpa``, the attention kernel) so that components can be removed. It
applies ``ln_scale`` on the query residuals but NOT the ``pre_norm`` /
``post_ln`` routing (the query stream is modulated without its pre-norm and
always normalised after each residual): the same op mix and shapes, no
value-level reference. The row "real trunk" times the port's own
``_dual_trunk`` on the same inputs, for comparison with "full".

Components: ``softmax`` (the query attention's scores and softmax; the
query values pass through), ``qattn`` (the whole query attention but its
output projection), ``qmlp``, ``xstream`` (the image stream's attention and
MLP), ``adaln`` (the per-position modulations), ``norms``. "adaLN hoisted"
computes every block's modulations before the loop. "full (kernel)" routes
the query attention through the attention kernel (the serving path),
"full (plain sdpa)" through plain fp32-softmax ``sdpa``.

Calibration: two clean products at the query stream's shapes (its qkv
linear and its MLP, scanned over the depth): once in bf16, as a share of
the card's bf16 peak, once in fp32 with TF32 off, as a share of its fp32
CUDA-core peak (``utils/peaks.py``). ``--prec`` sets TF32 for the fp32
products of the trunk: 'highest' off, 'high' on, 'default' as the process
has it. Times: ``utils.benchutil.time_fn`` (``iters`` 20, ``warm`` 3). One
JSON line with the card's name and power limit.

Flagship shapes (Enc-Qformer-Uni-XL/2): x [32, 256, 64], q [32, 512, 512],
depth 16, query attention [B, 8, 512, 768] at head dim 64.
"""

from __future__ import annotations

import argparse

import numpy as np
import torch

from selftoktokenizer_tpu_torch.core.config import FLAGSHIP_CONFIG, load_config
from selftoktokenizer_tpu_torch.tools import common

COMPONENTS = ("softmax", "qattn", "qmlp", "xstream", "adaln", "norms")
PREC_TF32_OFF = {"highest": True, "high": False, "default": None}


def bisect_config(yml, k):
    """The config, with the reference's K=1024 change (k, k_per_stage and
    the quantizer's K) when k is 1024."""
    from selftoktokenizer_tpu_torch.tools.measure_k1024 import k1024_config

    if k == 512:
        return load_config(yml)
    if k != 1024:
        raise ValueError("only the 512 and 1024 stage tables are defined")
    cfg = k1024_config(yml)
    cfg.tokenizer.params.quantizer_config.K = k
    return cfg


def make_trunk(enc, ecfg, skip=(), kernel=False, hoisted=False):
    """fn(x, q) -> (x, q) over every block of ``enc``: the proxy block
    with the components in ``skip`` removed."""
    from selftoktokenizer_tpu_torch.models.encoder import (
        _merge_heads, adaln_positions, dual_block_mods, mlp_apply)
    from selftoktokenizer_tpu_torch.ops import flash_attention as fa
    from selftoktokenizer_tpu_torch.ops.attention import sdpa
    from selftoktokenizer_tpu_torch.ops.linear import gate, linear, modulate
    from selftoktokenizer_tpu_torch.ops.norms import layer_norm

    C, Cq = ecfg.hidden_size, ecfg.query_dim
    H, QH = ecfg.num_heads, ecfg.query_heads
    s_ln = ecfg.ln_scale
    blocks = list(enc.blocks)
    positions = torch.as_tensor(adaln_positions(ecfg), dtype=torch.int32,
                                device=enc.query_tokens.device)

    def mods_of(bp, dt):
        if "adaln" in skip:
            return (None,) * 6
        return tuple(None if m is None else m.to(dt) for m in dual_block_mods(bp, positions))

    def ln(t):
        return t if "norms" in skip else layer_norm(t)

    def block(bp, x, q, mods):
        B, N, _ = x.shape
        K = q.shape[1]
        a = bp.attn
        shift_msa, scale_msa, gate_msa, shift_mlp, scale_mlp, gate_mlp = mods
        xn = ln(x)
        qn = modulate(q, shift_msa, scale_msa, 0)
        # the image stream's two projections (qkv, and k / v for the query)
        xqkv = linear(xn, a.qkv.weight, a.qkv.bias)
        kv = linear(xn, a.to_query_kv.weight, a.to_query_kv.bias)
        if "xstream" not in skip:
            xqkv = xqkv.reshape(B, N, 3, H, C // H).permute(2, 0, 3, 1, 4)
            x = x + linear(_merge_heads(sdpa(xqkv[0], xqkv[1], xqkv[2])), a.proj.weight,
                           a.proj.bias)
            x = x + mlp_apply(bp.mlp, ln(x))
        if "qattn" in skip:
            q_attn = linear(qn, a.query_proj.weight, a.query_proj.bias)
        else:
            qqkv = linear(qn, a.query_linear.weight, a.query_linear.bias).reshape(
                B, K, 3, QH, Cq // QH).permute(2, 0, 3, 1, 4)
            if "softmax" in skip:
                q_out = qqkv[0]
            else:
                kv = kv.reshape(B, N, 2, QH, Cq // QH).permute(2, 0, 3, 1, 4)
                k2 = torch.cat([kv[0], qqkv[1]], dim=2)
                v2 = torch.cat([kv[1], qqkv[2]], dim=2)
                q_out = (fa.flash_sdpa_key_mask(qqkv[0], k2, v2) if kernel
                         else sdpa(qqkv[0], k2, v2))
            q_attn = linear(_merge_heads(q_out), a.query_proj.weight, a.query_proj.bias)
        q = ln(s_ln * q + gate(q_attn, gate_msa))
        if "qmlp" not in skip:
            q = ln(s_ln * q + gate(mlp_apply(bp.q_mlp, modulate(q, shift_mlp, scale_mlp, 0)),
                                   gate_mlp))
        return x, q

    def trunk(x, q):
        if hoisted:
            all_mods = [mods_of(bp, x.dtype) for bp in blocks]
            for bp, mods in zip(blocks, all_mods):
                x, q = block(bp, x, q, mods)
        else:
            for bp in blocks:
                x, q = block(bp, x, q, mods_of(bp, x.dtype))
        return x, q

    return trunk


def variants(enc, ecfg):
    """(name, fn(x, q)) in the reference's order."""
    rows = [("full (plain sdpa)", make_trunk(enc, ecfg)),
            ("full (kernel)", make_trunk(enc, ecfg, kernel=True)),
            ("adaLN hoisted", make_trunk(enc, ecfg, hoisted=True))]
    rows += [(f"-{name}", make_trunk(enc, ecfg, skip=(name,))) for name in COMPONENTS]
    rows.append(("-qattn-qmlp", make_trunk(enc, ecfg, skip=("qattn", "qmlp"))))
    rows.append(("-all big", make_trunk(enc, ecfg, skip=("qattn", "qmlp", "xstream", "adaln"))))
    return rows


def calibration(B, K, Cq, depth, dtype, device, rng, iters):
    """A clean product scan at the query stream's two big shapes: (ms, FLOPs)."""
    from selftoktokenizer_tpu_torch.utils.benchutil import time_fn

    def w(a, b):
        return torch.from_numpy((rng.standard_normal((a, b)) / np.sqrt(a)).astype(np.float32)
                                ).to(device, dtype)

    q = torch.from_numpy(rng.standard_normal((B, K, Cq)).astype(np.float32)).to(device, dtype)
    w1, w2, w3 = w(Cq, 3 * Cq), w(Cq, 4 * Cq), w(4 * Cq, Cq)

    def scan():
        c = q
        for _ in range(depth):
            c = (c @ w1)[..., :Cq] + (c @ w2) @ w3
        return c

    flops = 2.0 * B * K * Cq * (3 * Cq + 4 * Cq + 4 * Cq) * depth
    return time_fn(scan, iters=iters, warm=3) * 1e3, flops


def build_parser():
    p = argparse.ArgumentParser("bench_encoder_bisect")
    p.add_argument("--prec", default="default", choices=tuple(PREC_TF32_OFF))
    p.add_argument("--batch", type=int, default=32)
    p.add_argument("--k", type=int, default=512,
                   help="query-token count (1024: the reference's K=1024 stage table)")
    p.add_argument("--yml-path", default=FLAGSHIP_CONFIG)
    p.add_argument("--iters", type=int, default=20)
    p.add_argument("--device", default="cuda", help="'cpu' to run on the CPU")
    return p


@torch.no_grad()
def main(argv=None):
    """Run the tool; returns the dict of its JSON line."""
    from selftoktokenizer_tpu_torch.models.encoder import _dual_trunk
    from selftoktokenizer_tpu_torch.ops.precision import fp32_exact
    from selftoktokenizer_tpu_torch.utils import peaks
    from selftoktokenizer_tpu_torch.utils.benchutil import time_fn

    args = build_parser().parse_args(argv)
    device = common.resolve_device(args.device)
    pipe = common.seeded_pipeline(bisect_config(args.yml_path, args.k), device,
                                  encode_only=True)
    enc, ecfg = pipe.encoder, pipe.tcfg.encoder
    B = args.batch
    N = (ecfg.input_size // ecfg.patch_size) ** 2
    C, Cq, K = ecfg.hidden_size, ecfg.query_dim, ecfg.K
    dt = torch.bfloat16
    rng = np.random.default_rng(0)
    x0 = torch.from_numpy(rng.standard_normal((B, N, C)).astype(np.float32)).to(device, dt)
    q0 = torch.from_numpy(rng.standard_normal((B, K, Cq)).astype(np.float32)).to(device, dt)
    print(f"shapes: x {tuple(x0.shape)} q {tuple(q0.shape)} depth {ecfg.depth} "
          f"prec {args.prec}", flush=True)

    def timed_ms(fn, *a):
        return time_fn(fn, *a, iters=args.iters, warm=3) * 1e3

    with fp32_exact(PREC_TF32_OFF[args.prec]):
        rows = [(name, timed_ms(fn, x0, q0)) for name, fn in variants(enc, ecfg)]
        # the port's own serving trunk on the latents-free embedded inputs
        real = timed_ms(lambda: _dual_trunk(enc, ecfg, x0, trunk_dtype=dt, fast_attn=True))
        rows.insert(2, ("real trunk (_dual_trunk, serving)", real))
    t_full = rows[1][1]          # the serving form: the kernel
    print(f"\n{'variant':36s} {'ms/iter':>9s} {'delta ms':>9s}")
    for name, t in rows:
        print(f"{name:36s} {t:9.3f} {t_full - t:9.3f}", flush=True)

    cal = {}
    for kind, dtype, tf32_off in (("bf16", torch.bfloat16, None), ("fp32", torch.float32, True)):
        with fp32_exact(tf32_off):
            ms, flops = calibration(B, K, Cq, ecfg.depth, dtype, device, rng, args.iters)
        share, peak = peaks.share(flops / (ms / 1e3), kind)
        if device.type != "cuda":
            share = None          # an H100 peak is no denominator of a CPU rate
        cal[kind] = {"ms": ms, "tflops": flops / (ms / 1e3) / 1e12, "share_of_peak": share,
                     "peak": peak}
        print(f"clean product scan ({kind}, query linear + query MLP shapes): {ms:.3f} ms -> "
              f"{cal[kind]['tflops']:.1f} TFLOP/s, {share} of the {peak}", flush=True)
    return common.emit({
        "shapes": {"x": list(x0.shape), "q": list(q0.shape), "depth": ecfg.depth},
        "prec": args.prec, "card": common.card_line(device),
        "rows": [{"variant": n, "ms": t, "delta_ms": t_full - t} for n, t in rows],
        "full_ms": t_full, "full_trunk_images_per_s": B / (t_full / 1e3),
        "calibration": cal,
        "proxy": "timing proxy of dual_block_apply: ln_scale kept, pre_norm / post_ln "
                 "routing left out"})


if __name__ == "__main__":
    main()
