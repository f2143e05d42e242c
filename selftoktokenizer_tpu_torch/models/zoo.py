"""Model registries: named encoder / decoder variants (counterpart of the
reference ``models/zoo.py``). The registry lists every named variant; the
encoder modes that are not ported yet raise when a module is built from
their config, not here.
"""

from __future__ import annotations

from selftoktokenizer_tpu_torch.core.config import none_str as _none_str
from selftoktokenizer_tpu_torch.models.encoder import EncoderConfig
from selftoktokenizer_tpu_torch.models.mmdit import MMDiTConfig

# name -> dict of encoder constructor overrides
ENC_MODELS = {
    # plain ViT encoders (mode 'vit')
    "Enc-Tiny/8":   dict(mode="vit", patch_size=8, hidden_size=256, num_heads=4),
    "Enc-Base/8":   dict(mode="vit", patch_size=8, hidden_size=768, num_heads=12),
    "Enc-Base/16":  dict(mode="vit", patch_size=16, hidden_size=256, num_heads=4),
    "Enc-L/8":      dict(mode="vit", patch_size=8, hidden_size=768, num_heads=16, depth=24, max_K=24),
    "Enc-H/8":      dict(mode="vit", patch_size=8, hidden_size=768, num_heads=16, depth=32, max_K=32),
    "Enc-H/8-XS":   dict(mode="vit", patch_size=8, hidden_size=256, num_heads=16, depth=32, max_K=32),
    "Enc-H/8-XS-24": dict(mode="vit", patch_size=8, hidden_size=256, num_heads=16, depth=24, max_K=32),
    "Enc-H2/8-XS":  dict(mode="vit", patch_size=8, hidden_size=256, num_heads=16, depth=40, max_K=40),
    "Enc-H3/8-XS":  dict(mode="vit", patch_size=8, hidden_size=256, num_heads=16, depth=48, max_K=48),
    "Enc-B/8-XS":   dict(mode="vit", patch_size=8, hidden_size=256, num_heads=16, depth=16, max_K=16),
    "Enc-H/4-XS":   dict(mode="vit", patch_size=4, hidden_size=64, num_heads=8, depth=32, max_K=32),
    "Enc-B/4-XS":   dict(mode="vit", patch_size=4, hidden_size=64, num_heads=8, depth=16, max_K=16),
    "Enc-H/8-XXS":  dict(mode="vit", patch_size=8, hidden_size=128, num_heads=8, depth=32, max_K=32),
    # Qformer bidirectional
    "Enc-Qformer-Bi-L/2":   dict(patch_size=2, hidden_size=16, num_heads=2, depth=24, query_dim=16, query_heads=2, bidirectional=True),
    "Enc-Qformer-Bi-WL/2":  dict(patch_size=2, hidden_size=128, num_heads=4, depth=24, query_dim=128, query_heads=4, bidirectional=True),
    "Enc-Qformer-Bi-UWL/2": dict(patch_size=2, hidden_size=256, num_heads=8, depth=24, query_dim=256, query_heads=8, bidirectional=True),
    "Enc-Qformer-Bi-WL/1":  dict(patch_size=1, hidden_size=128, num_heads=4, depth=24, query_dim=128, query_heads=4, bidirectional=True),
    "Enc-Qformer-Bi-UWL/1": dict(patch_size=1, hidden_size=256, num_heads=8, depth=24, query_dim=256, query_heads=8, bidirectional=True),
    "Enc-Qformer-Bi-XL/2":  dict(patch_size=2, hidden_size=512, num_heads=4, depth=16, query_dim=512, query_heads=4, bidirectional=True),
    # Qformer unidirectional
    "Enc-Qformer-Uni-M/2":   dict(patch_size=2, hidden_size=64, num_heads=4, depth=16, query_dim=64, query_heads=4, bidirectional=False),
    "Enc-Qformer-Uni-L/2":   dict(patch_size=2, hidden_size=64, num_heads=4, depth=20, query_dim=128, query_heads=8, bidirectional=False),
    "Enc-Qformer-Uni-XL/2":  dict(patch_size=2, hidden_size=64, num_heads=4, depth=16, query_dim=512, query_heads=8, bidirectional=False),
    "Enc-Qformer-Uni-XL/1":  dict(patch_size=1, hidden_size=64, num_heads=4, depth=24, query_dim=256, query_heads=8, bidirectional=False),
    "Enc-Qformer-Uni-L2/2":  dict(patch_size=2, hidden_size=128, num_heads=4, depth=24, query_dim=128, query_heads=4, bidirectional=False),
    "Enc-Qformer-Uni-WL/2":  dict(patch_size=2, hidden_size=128, num_heads=4, depth=24, query_dim=256, query_heads=8, bidirectional=False),
    "Enc-Qformer-Uni-WL/1":  dict(patch_size=1, hidden_size=128, num_heads=4, depth=24, query_dim=256, query_heads=8, bidirectional=False),
    "Enc-Qformer-Uni-WXL/1": dict(patch_size=1, hidden_size=256, num_heads=4, depth=28, query_dim=256, query_heads=4, bidirectional=False),
    "Enc-Qformer-Uni-WXL/2": dict(patch_size=2, hidden_size=256, num_heads=4, depth=28, query_dim=256, query_heads=4, bidirectional=False),
    "Enc-Qformer-Uni-WXL/3": dict(patch_size=1, hidden_size=256, num_heads=4, depth=28, query_dim=512, query_heads=4, bidirectional=False),
    "Enc-Qformer-Uni-WXL/4": dict(patch_size=2, hidden_size=256, num_heads=4, depth=28, query_dim=512, query_heads=4, bidirectional=False),
    "Enc-Qformer-Uni-WXL/5": dict(patch_size=2, hidden_size=256, num_heads=4, depth=28, query_dim=512, query_heads=8, bidirectional=False),
    "Enc-Qformer-Uni0-WL/1": dict(patch_size=1, hidden_size=128, num_heads=4, depth=24, query_dim=256, query_heads=8, bidirectional=False, zero_init=True),
    "Enc-Qformer-Uni-UWL/1": dict(patch_size=1, hidden_size=256, num_heads=8, depth=24, query_dim=256, query_heads=8, bidirectional=False),
    # small smoke / test variant
    "Enc-Qformer-Uni-Tiny/2": dict(patch_size=2, hidden_size=32, num_heads=4, depth=2, query_dim=64, query_heads=8, bidirectional=False),
    # same shape family as the flagship Uni-XL/2 at 6 blocks / query_dim 128
    "Enc-Qformer-Uni-S/2": dict(patch_size=2, hidden_size=64, num_heads=4, depth=6, query_dim=128, query_heads=8, bidirectional=False),
    "Enc-Qformer-Multi-Res-Uni-XL/2": dict(
        patch_size=2, hidden_size=64, num_heads=4, depth=16, query_dim=512,
        query_heads=8, bidirectional=False, multires=True),
}

DIT_MODELS = ["MMDiT_XL", "MMDiT_XL_Renderer", "RenderDiT_XL"]


def build_encoder_config(name, K, input_size, encoder_hidden_size, in_channels,
                         quantizer_config, encoder_config=None,
                         diti_positions=True) -> EncoderConfig:
    """Named encoder -> EncoderConfig, folding in the per-run kwargs and the
    YAML encoder_config block."""
    spec = dict(ENC_MODELS[name])
    if spec.pop("multires", None):
        raise NotImplementedError(
            f"the multi-resolution encoder {name!r} is not ported yet: ROADMAP.md "
            "queue item 'remaining encoder modes / multires / DiT / DDPM / text encoders'")
    max_k = spec.pop("max_K", None)
    if max_k is not None:
        assert K <= max_k, f"{name} supports K up to {max_k}"
    mode = spec.pop("mode", None)
    ec = dict(encoder_config or {})
    ec.pop("diti", None)
    qformer_mode = ec.pop("qformer_mode", "qformer")
    return EncoderConfig(
        K=K, input_size=input_size, encoder_hidden_size=encoder_hidden_size,
        in_channels=in_channels,
        qformer_mode=mode or qformer_mode,
        diti_positions=diti_positions,
        code_dim=quantizer_config["code_dim"],
        codebook_size=quantizer_config["codebook_size"],
        **spec, **{k: v for k, v in ec.items()
                   if k in ("pre_norm", "post_norm", "time_adaln", "qk_norm",
                            "attn_mask", "single_token", "pos_embed_max_size",
                            "post_ln")},
    )


def build_decoder_config(name, K, input_size, encoder_hidden_size, in_channels,
                         decoder_config=None, diti_positions=True) -> MMDiTConfig:
    """Named decoder -> MMDiTConfig (MMDiT_XL: depth 24, patch 2,
    pos_embed_max_size 192, num_patches 36864, context 16 -> 1536)."""
    assert name in DIT_MODELS, name
    dc = dict(decoder_config or {})
    dc.pop("diti", None)
    time_adaln = dc.get("time_adaln", False)
    return MMDiTConfig(
        depth=dc.get("depth", 24), K=K, patch_size=2, in_channels=in_channels,
        pos_embed_max_size=dc.get("pos_embed_max_size", 192),
        num_patches=dc.get("num_patches", 36864),
        encoder_hidden_size=encoder_hidden_size,
        context_dim=dc.get("context_dim", 64 * dc.get("depth", 24)),
        adm_in_channels=encoder_hidden_size,
        class_dropout_prob=dc.get("class_dropout_prob", 0.1),
        time_adaln=time_adaln if time_adaln else "t_emb",
        diti_positions=diti_positions,
        sd3_cond_pooling=_none_str(dc.get("sd3_cond_pooling")),
        uncond_y_file=_none_str(dc.get("uncond_y_file")),
        uncond_c_file=_none_str(dc.get("uncond_c_file")),
        qk_norm=_none_str(dc.get("qk_norm")),
        renderer=name.endswith("Renderer") or name.startswith("RenderDiT"),
        input_size=input_size,
        repeat_mask_token=dc.get("repeat", False),
    )
