"""The yardstick: the card's published peaks, the model FLOPs of each call,
and the least time of the kernels whose roofline share the benchmark
reports. A frozen copy of the program's arithmetic (its FLOP counts, its
peaks, the kernel bounds of its smoke test), corrected where noted, so
that no later change to the program moves the measure.

FLOPs are the logical multiply-adds x 2 of the products (matmuls and
convolutions); elementwise, norm and softmax work is left out.
"""

from __future__ import annotations

# ----------------------------------------------------------------- peaks
# One NVIDIA H100 SXM, dense, at its 700 W limit (NVIDIA's data sheet).
BF16_FLOPS = 989e12        # bf16 tensor cores, fp32 accumulate
TF32_FLOPS = 495e12        # TF32 tensor cores
FP32_EXACT_FLOPS = TF32_FLOPS / 3   # fp32-accurate products: split TF32, three passes
INT8_OPS = 1979e12
BYTES = 3.35e12            # HBM3 bytes a second

PEAKS = {"bf16": BF16_FLOPS, "fp32": FP32_EXACT_FLOPS, "int8": INT8_OPS}


def least_time(flops_by_class):
    """Seconds the card needs at least for {class: FLOPs}, each class at
    its own peak."""
    return sum(f / PEAKS[k] for k, f in flops_by_class.items())


# ----------------------------------------------------------------- FLOPs

def _linear(tokens, d_in, d_out):
    return 2.0 * tokens * d_in * d_out


def _attn(q_tokens, kv_tokens, dim):
    return 4.0 * q_tokens * kv_tokens * dim         # q k^T and p v


def _conv(h, w, cin, cout, k=3):
    return 2.0 * h * w * cin * cout * k * k


def vae_encoder_flops(res, v):
    ch = v["ch"]
    f = _conv(res, res, v["in_channels"], ch)
    h, cin = res, ch
    for i, mult in enumerate(v["ch_mult"]):
        cout = ch * mult
        for _ in range(v["num_res_blocks"]):
            f += _conv(h, h, cin, cout) + _conv(h, h, cout, cout)
            if cin != cout:
                f += _conv(h, h, cin, cout, k=1)
            cin = cout
        if i != len(v["ch_mult"]) - 1:
            f += _conv(h // 2, h // 2, cout, cout)
            h //= 2
    c = ch * v["ch_mult"][-1]
    f += 2 * (_conv(h, h, c, c) * 2)
    f += 4 * _linear(h * h, c, c) + _attn(h * h, h * h, c)
    return f + _conv(h, h, c, 2 * v["z_channels"])


def vae_decoder_flops(res, v):
    ch = v["ch"]
    h = res // 2 ** (len(v["ch_mult"]) - 1)
    c = ch * v["ch_mult"][-1]
    f = _conv(h, h, v["z_channels"], c)
    f += 2 * (_conv(h, h, c, c) * 2)
    f += 4 * _linear(h * h, c, c) + _attn(h * h, h * h, c)
    cin = c
    for i, mult in reversed(list(enumerate(v["ch_mult"]))):
        cout = ch * mult
        for _ in range(v["num_res_blocks"] + 1):
            f += _conv(h, h, cin, cout) + _conv(h, h, cout, cout)
            if cin != cout:
                f += _conv(h, h, cin, cout, k=1)
            cin = cout
        if i != 0:
            h *= 2
            f += _conv(h, h, cout, cout)
    return f + _conv(h, h, cin, v["out_ch"])


def encoder_flops(e, res):
    """The unidirectional dual encoder and the VQ's cosine scores against the
    whole codebook, one image."""
    n = (res // 8 // e["patch_size"]) ** 2
    dx, dq, K = e["hidden_size"], e["query_dim"], e["K"]
    r = e["mlp_ratio"]
    f = _linear(n, e["patch_size"] ** 2 * e["in_channels"], dx)
    per_block = (_linear(n, dx, 3 * dx) + _linear(n, dx, dx) + 2 * _linear(n, dx, r * dx)
                 + _attn(n, n, dx)
                 + _linear(K, dq, 3 * dq) + 2 * _linear(n, dx, dq) + _attn(K, n + K, dq)
                 + _linear(K, dq, dq) + 2 * _linear(K, dq, r * dq))
    f += e["depth"] * per_block
    f += _linear(K, dq, e["code_dim"])
    return f + _linear(K, e["code_dim"], e["codebook_size"])     # the scores


def mmdit_flops(d, n_x, Lc, ctx_rows_see_x=True):
    """One MMDiT forward over n_x image tokens and Lc context tokens, one
    image. With ``ctx_rows_see_x`` False (the renderer) the context rows
    attend over the context keys alone."""
    D, r = d["hidden_size"], d["mlp_ratio"]
    L = n_x + Lc
    attn = _attn(L, L, D) if ctx_rows_see_x else _attn(Lc, Lc, D) + _attn(n_x, L, D)
    per_block = _linear(L, D, 3 * D) + attn + _linear(L, D, D) + 2 * _linear(L, D, r * D)
    f = d["depth"] * per_block
    f += _linear(Lc, d["encoder_hidden_size"], D)
    if not d["renderer"]:
        f += _linear(n_x, d["patch_size"] ** 2 * d["in_channels"], D)
    return f + _linear(n_x, D, d["patch_size"] ** 2 * d["in_channels"])


def decode_flops(cfg, step_contexts):
    """The sampler's MMDiT calls (one a step, over each step's context
    bucket: the pipeline cuts the masked context to the 128-multiple that
    covers the step's active tokens) and the VAE decoder, one image."""
    d = cfg["decoder"]
    n_x = (cfg["image_size"] // 8 // d["patch_size"]) ** 2
    return (sum(mmdit_flops(d, n_x, Lc) for Lc in step_contexts),
            vae_decoder_flops(cfg["image_size"], cfg["vae"]))


def render_flops(cfg):
    """One renderer pass over the K tokens and the latent grid, and the VAE
    decoder, one image."""
    d = cfg["decoder"]
    n_x = (d["input_size"] // d["patch_size"]) ** 2
    return (mmdit_flops(d, n_x, cfg["K"], ctx_rows_see_x=False),
            vae_decoder_flops(cfg["image_size"], cfg["vae"]))


# ---------------------------------------------------------------- bounds

def attention_bound(B, H, Lq, Lk, D, item, active_keys):
    """Seconds at least for one attention call: both products over each
    row's active keys (``active_keys``: summed over the batch rows) at the
    bf16 peak (item 2) or in split TF32 (item 4), against reading q and
    the active keys' k and v, writing the output and reading a key mask
    once."""
    flops = 4.0 * H * Lq * D * active_keys
    t_ops = flops / BF16_FLOPS if item == 2 else flops / FP32_EXACT_FLOPS
    nbytes = (2 * B * Lq + 2 * active_keys) * D * H * item + B * Lk
    return max(t_ops, nbytes / BYTES)


def attention_backward_bound(B, H, Lq, Lk, D, item, active_keys):
    """Seconds at least for one attention backward: five products (the
    scores again, dV, dP, dQ, dK) over each row's active keys, against
    reading q, dO and the active keys' k and v, and writing dq, dk and dv
    once (dk and dv for every key)."""
    flops = 10.0 * H * Lq * D * active_keys
    t_ops = flops / BF16_FLOPS if item == 2 else flops / FP32_EXACT_FLOPS
    nbytes = (3 * B * Lq + 2 * active_keys + 2 * B * Lk) * D * H * item
    return max(t_ops, nbytes / BYTES)


def train_flops(cfg, batch):
    """One training step: three times the forward (the encoder, its VQ
    scores and one decoder call over the whole context), the program's
    convention for a train step's model FLOPs."""
    d = cfg["decoder"]
    n_x = (cfg["image_size"] // 8 // d["patch_size"]) ** 2
    return 3.0 * batch * (encoder_flops(cfg["encoder"], cfg["image_size"])
                          + mmdit_flops(d, n_x, cfg["K"]))


def vq_bound(N, C, D, sm_clock_hz, sms=132):
    """Seconds at least for the screen-and-rescore argmax of N rows over C
    codes: its TF32 products, one compare a score on the CUDA cores (128
    lanes an SM a clock), or its bytes, whichever is largest."""
    t_tf32 = 2.0 * N * C * D / TF32_FLOPS
    t_cmp = N * C / (sms * 128 * sm_clock_hz)
    t_bytes = (N * D * 4 + C * D * 4 + N * 4) / BYTES
    return max(t_tf32, t_cmp, t_bytes)
