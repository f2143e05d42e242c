"""Analytic model-FLOP counts (counterpart of the reference
``utils/flops.py``, the same arithmetic): the numerator of a share of the
card's peak.

Counts are logical matmul / conv multiply-adds x 2 (the usual model-FLOPs
convention); elementwise, norm and softmax work is left out (under 1 % on
these graphs). Every function returns FLOPs for ONE image / sample, except
``qformer_encoder_mxu_slots``, whose unit is the TPU's: the reference
counts the encoder's products padded to its 128-wide matrix unit (MXU).

All functions return numbers equal to the reference's on the same configs.
"""

from __future__ import annotations


def _linear(tokens, d_in, d_out):
    return 2.0 * tokens * d_in * d_out


def _attn(q_tokens, kv_tokens, dim):
    # q@k^T and attn@v
    return 2.0 * 2.0 * q_tokens * kv_tokens * dim


def _conv(h, w, cin, cout, k=3):
    return 2.0 * h * w * cin * cout * k * k


def vae_encoder_flops(resolution, cfg=None):
    """SD3 VAE encoder (models/vae.py: ch 128, mult (1,2,4,4), 2 res blocks,
    mid block + attention, conv_out to 2*z)."""
    if cfg is None:
        from selftoktokenizer_tpu_torch.models.vae import VAEConfig

        cfg = VAEConfig()
    ch = cfg.ch
    f = _conv(resolution, resolution, cfg.in_channels, ch)
    h = resolution
    cin = ch
    for i, mult in enumerate(cfg.ch_mult):
        cout = ch * mult
        for _ in range(cfg.num_res_blocks):
            f += _conv(h, h, cin, cout) + _conv(h, h, cout, cout)
            if cin != cout:
                f += _conv(h, h, cin, cout, k=1)
            cin = cout
        if i != len(cfg.ch_mult) - 1:
            f += _conv(h // 2, h // 2, cout, cout)  # strided downsample
            h //= 2
    # mid: res + attn + res at h x h, c = ch*mult[-1]
    c = ch * cfg.ch_mult[-1]
    f += 2 * (_conv(h, h, c, c) * 2)
    f += 4 * _linear(h * h, c, c) + _attn(h * h, h * h, c)   # qkv+proj+attn
    f += _conv(h, h, c, 2 * cfg.z_channels)
    return f


def vae_decoder_flops(resolution, cfg=None):
    """Decoder mirrors the encoder with 3 res blocks per level and runs at
    full resolution longer — roughly 2.5x the encoder; counted exactly."""
    if cfg is None:
        from selftoktokenizer_tpu_torch.models.vae import VAEConfig

        cfg = VAEConfig()
    ch = cfg.ch
    h = resolution // 2 ** (len(cfg.ch_mult) - 1)
    c = ch * cfg.ch_mult[-1]
    f = _conv(h, h, cfg.z_channels, c)
    f += 2 * (_conv(h, h, c, c) * 2)
    f += 4 * _linear(h * h, c, c) + _attn(h * h, h * h, c)
    cin = c
    for i, mult in reversed(list(enumerate(cfg.ch_mult))):
        cout = ch * mult
        for _ in range(cfg.num_res_blocks + 1):
            f += _conv(h, h, cin, cout) + _conv(h, h, cout, cout)
            if cin != cout:
                f += _conv(h, h, cin, cout, k=1)
            cin = cout
        if i != 0:
            h *= 2
            f += _conv(h, h, cout, cout)  # upsample conv
    f += _conv(h, h, cin, cfg.out_ch)
    return f


def qformer_encoder_flops(cfg, resolution=None):
    """Dual-mode QformerEncoder (models/encoder.py EncoderConfig).

    resolution: image pixels — the variable-size encode path processes a
    (resolution/8)^2 latent grid, so the image-stream token count scales
    with it; None uses the config's native input_size (256px -> 32)."""
    if resolution is not None:
        n = (resolution // 8 // cfg.patch_size) ** 2
    else:
        n = (cfg.input_size // cfg.patch_size) ** 2  # image tokens
    dx = cfg.hidden_size
    dq = cfg.query_dim
    K = cfg.K
    f = _linear(n, cfg.patch_size ** 2 * cfg.in_channels, dx)  # patch embed
    per_block = (
        # image stream: qkv + proj + mlp(4x) + self-attn
        _linear(n, dx, 3 * dx) + _linear(n, dx, dx)
        + 2 * _linear(n, dx, 4 * dx) + _attn(n, n, dx)
        # query stream: qkv at dq, image k/v projected dx->dq (x2), attn
        # over [img ; query] keys, proj, mlp(4x)
        + _linear(K, dq, 3 * dq) + 2 * _linear(n, dx, dq)
        + _attn(K, n + K, dq) + _linear(K, dq, dq)
        + 2 * _linear(K, dq, 4 * dq)
        # per-position adaLN tables are precomputed outside the batch loop
    )
    f += cfg.depth * per_block
    f += _linear(K, dq, cfg.code_dim)                 # VQ project_in
    f += _linear(K, cfg.code_dim, cfg.codebook_size)  # distance matmul
    return f


def _pad128(d):
    return -(-d // 128) * 128


def qformer_encoder_mxu_slots(cfg, resolution=None):
    """The Qformer encoder's count in TPU MXU slots: the logical FLOPs with
    each matmul's contraction and output dims padded to 128 lanes, the
    width of the TPU's matrix unit (the reference's denominator of an
    encoder utilization on that chip). It is no count of the H100's work:
    its tensor cores tile by 64 rows and 8-16 columns, not 128 x 128; kept
    so that the port's numbers equal the reference's."""
    if resolution is not None:
        n = (resolution // 8 // cfg.patch_size) ** 2
    else:
        n = (cfg.input_size // cfg.patch_size) ** 2
    dx = cfg.hidden_size
    dq = cfg.query_dim
    K = cfg.K
    hx = dx // cfg.num_heads          # image-stream head_dim
    hq = dq // cfg.query_heads        # query-stream head_dim

    def lin(tokens, d_in, d_out):
        return 2.0 * tokens * _pad128(d_in) * _pad128(d_out)

    def attn(q_tokens, kv_tokens, n_heads, head_dim):
        # scores: contraction head_dim pads; output kv_tokens pads.
        # attn@v: contraction kv_tokens pads; output head_dim pads.
        return 2.0 * n_heads * q_tokens * (
            _pad128(head_dim) * _pad128(kv_tokens)
            + _pad128(kv_tokens) * _pad128(head_dim))

    f = lin(n, cfg.patch_size ** 2 * cfg.in_channels, dx)
    per_block = (
        lin(n, dx, 3 * dx) + lin(n, dx, dx)
        + 2 * lin(n, dx, 4 * dx) + attn(n, n, cfg.num_heads, hx)
        + lin(K, dq, 3 * dq) + 2 * lin(n, dx, dq)
        + attn(K, n + K, cfg.query_heads, hq) + lin(K, dq, dq)
        + 2 * lin(K, dq, 4 * dq)
    )
    f += cfg.depth * per_block
    f += lin(K, dq, cfg.code_dim)
    f += lin(K, cfg.code_dim, cfg.codebook_size)
    return f


def mmdit_step_flops(cfg, n_x=None, Lc=None):
    """One MMDiT forward (models/mmdit.py MMDiTConfig): joint-attention DiT,
    depth blocks of [ctx + x] tokens at hidden 64*depth."""
    d = cfg.hidden_size
    n_x = n_x if n_x is not None else (cfg.input_size // cfg.patch_size) ** 2
    Lc = Lc if Lc is not None else cfg.K
    L = n_x + Lc + cfg.register_length
    per_block = (
        _linear(L, d, 3 * d)          # qkv (both streams)
        + _attn(L, L, d)
        + _linear(L, d, d)            # proj
        + 2 * _linear(L, d, 4 * d)    # mlp
    )
    f = cfg.depth * per_block
    f += _linear(Lc, cfg.encoder_hidden_size, d)      # context embed
    f += _linear(n_x, cfg.patch_size ** 2 * cfg.in_channels, d)  # x embed
    f += _linear(n_x, d, cfg.patch_size ** 2 * cfg.out_ch)       # final
    return f


def encode_flops(tcfg, resolution):
    """Full pipeline encode: VAE encoder (bf16) + Qformer encoder + VQ."""
    return (vae_encoder_flops(resolution),
            qformer_encoder_flops(tcfg.encoder, resolution=resolution))


def decode50_flops(tcfg, resolution, steps=50, cfg_scale=1.0):
    """50-step diffusion decode: steps x MMDiT + VAE decoder.

    CFG accounting matches what the pipeline EXECUTES: with
    register_length == 0 the uncond branch is the x-only trunk
    (mmdit_uncond_xonly — masked context keys are provably dead, so the
    uncond pass runs with zero context tokens, ~1/3 of a cond pass at
    256px); with register tokens it falls back to a full second forward."""
    n_x = (resolution // 8 // tcfg.decoder.patch_size) ** 2
    per_step = mmdit_step_flops(tcfg.decoder, n_x=n_x)
    if cfg_scale != 1.0:
        if tcfg.decoder.register_length == 0:
            per_step += mmdit_step_flops(tcfg.decoder, n_x=n_x, Lc=0)
        else:
            per_step *= 2
    return steps * per_step + vae_decoder_flops(resolution)
