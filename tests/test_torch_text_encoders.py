"""The port's SD3 text encoders and checkpoint converters against the JAX
package's on the CPU: CLIP (both activations, an intermediate layer counted
from either end, pooling at the end token), T5 (the relative-position
buckets, the shared bias) and the SD-CLIP wrappers within 1e-4 of scale on
carried seeded weights; the prompt tokenizers through one stub tokenizer
callable that both packages take; every ``ldm_convert`` function on the
same seeded dict (keys equal, values equal); and the round trip of the
port's CLIP and T5 state dicts through the JAX package's converters."""

import numpy as np
import pytest
import torch
import jax.numpy as jnp

from selftoktokenizer_tpu.core import ldm_convert as j_ldm
from selftoktokenizer_tpu.models import text_encoders as j_te
from selftoktokenizer_tpu_torch.core import convert
from selftoktokenizer_tpu_torch.core import ldm_convert as t_ldm
from selftoktokenizer_tpu_torch.models import text_encoders as t_te
from tests.torch_port_helpers import jax_tree, seeded_tree, to_np

REL_TOL = 1e-4
CLIP = dict(num_hidden_layers=3, hidden_size=32, num_attention_heads=4, intermediate_size=64,
            vocab_size=100, num_positions=16)
T5 = dict(num_layers=3, d_model=32, d_ff=48, num_heads=4, vocab_size=100,
          relative_attention_num_buckets=8, relative_attention_max_distance=16)


def _rel(got, want):
    got, want = to_np(got), to_np(want)
    return np.abs(got - want).max() / np.abs(want).max()


def _clip(seed, act="quick_gelu"):
    jcfg = j_te.CLIPTextConfig(**CLIP, hidden_act=act)
    tcfg = t_te.CLIPTextConfig(**CLIP, hidden_act=act)
    tree = seeded_tree(lambda k: j_te.clip_text_init(k, jcfg), seed)
    return jcfg, jax_tree(tree), tcfg, convert.clip_text_from_jax_tree(tree, tcfg)


def _t5(seed):
    jcfg, tcfg = j_te.T5Config(**T5), t_te.T5Config(**T5)
    tree = seeded_tree(lambda k: j_te.t5_init(k, jcfg), seed)
    return jcfg, jax_tree(tree), tcfg, convert.t5_from_jax_tree(tree, tcfg)


def _tokens(L=12):
    rng = np.random.default_rng(1)
    tok = rng.integers(1, 90, (2, L)).astype(np.int32)
    tok[0, 5], tok[1, 9] = 99, 99          # the end token: the largest id
    return tok


def _close_all(got, want):
    for g, w in zip(got, want):
        assert (g is None) == (w is None)
        if g is not None:
            assert _rel(g, w) <= REL_TOL, _rel(g, w)


@pytest.mark.parametrize("act,io,ln", [("quick_gelu", None, True), ("gelu", -2, False),
                                       ("quick_gelu", 1, True)])
def test_clip_matches_jax(act, io, ln):
    jcfg, jp, tcfg, model = _clip(3, act)
    tok = _tokens()
    want = j_te.clip_text_apply(jp, jcfg, jnp.asarray(tok), intermediate_output=io,
                                final_layer_norm_intermediate=ln)
    with torch.no_grad():
        got = t_te.clip_text_apply(model, tcfg, torch.from_numpy(tok).long(),
                                   intermediate_output=io, final_layer_norm_intermediate=ln)
    _close_all(got, want)
    # pooled at the end token, the position of each row's largest id
    assert torch.equal(got[3][0], got[0][0, 5]) and torch.equal(got[3][1], got[0][1, 9])


def test_t5_matches_jax():
    jcfg, jp, tcfg, model = _t5(4)
    rel = np.arange(-20, 21)[None, :] - np.zeros((1, 1), np.int64)
    np.testing.assert_array_equal(
        t_te.t5_relative_position_bucket(torch.from_numpy(rel), 8, 16).numpy(),
        np.asarray(j_te.t5_relative_position_bucket(jnp.asarray(rel), 8, 16)))
    tok = _tokens()
    for io in (None, -2):
        want = j_te.t5_apply(jp, jcfg, jnp.asarray(tok), intermediate_output=io)
        with torch.no_grad():
            got = t_te.t5_apply(model, tcfg, torch.from_numpy(tok).long(), intermediate_output=io)
        _close_all(got, want)


def test_sd_clip_wrappers_match_jax():
    jcfg, jp, tcfg, model = _clip(5, "gelu")
    tok = _tokens().tolist()
    for kw in (dict(), dict(layer="hidden", layer_idx=-2),
               dict(return_projected_pooled=False, layer_norm_hidden_state=False)):
        _close_all(t_te.SDClipModel(model, tcfg, **kw)(tok),
                   j_te.SDClipModel(jp, jcfg, **kw)(tok))
    _close_all(t_te.sdxl_clip_g(model, tcfg)(tok), j_te.sdxl_clip_g(jp, jcfg)(tok))
    pairs = [[(t, 1.0) for t in tok[0]]]
    _close_all(t_te.SDClipModel(model, tcfg).encode_token_weights(pairs),
               j_te.SDClipModel(jp, jcfg).encode_token_weights(pairs))
    j5cfg, j5p, t5cfg, t5m = _t5(6)
    for kw in (dict(), dict(layer="hidden", layer_idx=-2)):
        _close_all(t_te.t5xxl_model(t5m, t5cfg, **kw)(tok), j_te.t5xxl_model(j5p, j5cfg, **kw)(tok))


def test_clip_and_t5_state_dict_round_trip():
    jcfg, _, tcfg, model = _clip(7)
    sd = {k: v.numpy() for k, v in model.state_dict().items()}
    jp = jax_tree(j_te.clip_text_from_state_dict(sd, jcfg))
    tok = _tokens()
    with torch.no_grad():
        got = t_te.clip_text_apply(model, tcfg, torch.from_numpy(tok).long())
    _close_all(got, j_te.clip_text_apply(jp, jcfg, jnp.asarray(tok)))
    jcfg, _, tcfg, model = _t5(8)
    sd = {k: v.numpy() for k, v in model.state_dict().items()}
    jp = jax_tree(j_te.t5_from_state_dict(sd, jcfg))
    with torch.no_grad():
        got = t_te.t5_apply(model, tcfg, torch.from_numpy(tok).long())
    _close_all(got, j_te.t5_apply(jp, jcfg, jnp.asarray(tok)))


class StubTokenizer:
    """An HF-style tokenizer callable: a start token (or none), one id per
    character, an end token."""

    def __init__(self, start, end):
        self.start, self.end = start, end

    def __call__(self, text):
        ids = [100 + ord(c) % 50 for c in text]
        return {"input_ids": ([self.start] if self.start is not None else []) + ids + [self.end]}


def test_tokenizers_match_jax():
    clip_tok, t5_tok = StubTokenizer(49406, 49407), StubTokenizer(None, 1)
    text = "a photo of\na  cat"
    want = j_te.SD3Tokenizer(clip_tok, t5_tok).tokenize_with_weights(text)
    got = t_te.SD3Tokenizer(clip_tok, t5_tok).tokenize_with_weights(text)
    assert got == want
    assert len(got["l"][0]) == 77 and got["l"][0][-1][0] == 49407 and got["g"][0][-1][0] == 0
    assert len(got["t5xxl"][0]) == 77 and got["t5xxl"][0][0][0] != 49406
    one = dict(max_length=8, tokenizer=clip_tok)
    assert t_te.SDTokenizer(**one).tokenize_with_weights("ab c") == \
        j_te.SDTokenizer(**one).tokenize_with_weights("ab c")


# --------------------------------------------------------------- ldm_convert ---

def _seeded(keys_shapes, seed):
    rng = np.random.default_rng(seed)
    return {k: rng.standard_normal(s).astype(np.float32) for k, s in keys_shapes}


def _same(got, want):
    assert list(got) == list(want)
    for k in want:
        np.testing.assert_array_equal(to_np(got[k]), to_np(want[k]), err_msg=k)


def _both(fn_t, fn_j, sd_np, *a, **kw):
    return fn_t({k: torch.from_numpy(v) for k, v in sd_np.items()}, *a, **kw), \
        fn_j(sd_np, *a, **kw)


def test_ldm_vae_and_clip_extraction():
    sd = _seeded([("first_stage_model.encoder.conv_in.weight", (4, 3, 3, 3)),
                  ("first_stage_model.decoder.conv_out.bias", (3,)),
                  ("model.diffusion_model.input_blocks.0.0.weight", (4, 4)),
                  ("cond_stage_model.transformer.text_model.embeddings.position_ids", (1, 77)),
                  ("cond_stage_model.transformer.text_model.encoder.layers.0.self_attn.q_proj"
                   ".weight", (8, 8)),
                  ("cond_stage_model.transformer.text_model.final_layer_norm.bias", (8,))], 1)
    _same(*_both(t_ldm.ldm_vae_state_dict, j_ldm.ldm_vae_state_dict, sd))
    _same(*_both(t_ldm.ldm_clip_state_dict, j_ldm.ldm_clip_state_dict, sd))


@pytest.mark.parametrize("layers", [23, 2])
def test_open_clip_state_dict(layers):
    d, pre = 8, "cond_stage_model.model."
    ks = [(pre + "positional_embedding", (77, d)), (pre + "token_embedding.weight", (50, d)),
          (pre + "ln_final.weight", (d,)), (pre + "ln_final.bias", (d,)),
          (pre + "text_projection", (d, d))]
    for i in (0, 2, 20, 23):
        b = f"{pre}transformer.resblocks.{i}."
        ks += [(b + "attn.in_proj_weight", (3 * d, d)), (b + "attn.in_proj_bias", (3 * d,)),
               (b + "attn.out_proj.weight", (d, d)), (b + "ln_1.weight", (d,)),
               (b + "ln_2.bias", (d,)), (b + "mlp.c_fc.weight", (4 * d, d)),
               (b + "mlp.c_proj.bias", (d,))]
    got, want = _both(t_ldm.open_clip_state_dict, j_ldm.open_clip_state_dict, _seeded(ks, 2),
                      num_hidden_layers=layers)
    _same(got, want)
    assert not any(f"layers.{layers}." in k for k in got)


def test_merge_lora():
    base = _seeded([("down_blocks.0.attentions.0.proj_in.weight", (8, 6)),
                    ("down_blocks.0.resnets.0.conv1.weight", (8, 6, 1, 1)),
                    ("text_model.encoder.layers.0.self_attn.q_proj.weight", (8, 8)),
                    ("mid_block.attentions.0.proj_out.bias", (8,))], 3)
    lora = _seeded([("lora_unet_down_blocks_0_attentions_0_proj_in.lora_down.weight", (2, 6)),
                    ("lora_unet_down_blocks_0_attentions_0_proj_in.lora_up.weight", (8, 2)),
                    ("lora_unet_down_blocks_0_attentions_0_proj_in.alpha", ()),
                    ("lora_unet_down_blocks_0_resnets_0_conv1.lora_up.weight", (8, 2, 1, 1)),
                    ("lora_unet_down_blocks_0_resnets_0_conv1.lora_down.weight", (2, 6, 1, 1)),
                    ("lora_te_text_model_encoder_layers_0_self_attn_q_proj.lora_down.weight",
                     (2, 8)),
                    ("lora_te_text_model_encoder_layers_0_self_attn_q_proj.lora_up.weight",
                     (8, 2))], 4)
    t_base = {k: torch.from_numpy(v) for k, v in base.items()}
    got = t_ldm.merge_lora(t_base, {k: torch.from_numpy(v) for k, v in lora.items()}, alpha=0.6)
    want = j_ldm.merge_lora(base, lora, alpha=0.6)
    _same(got, want)
    assert torch.equal(t_base["down_blocks.0.resnets.0.conv1.weight"],
                       torch.from_numpy(base["down_blocks.0.resnets.0.conv1.weight"]))
    assert not torch.equal(got["down_blocks.0.resnets.0.conv1.weight"],
                           t_base["down_blocks.0.resnets.0.conv1.weight"])


def test_merge_motion_lora():
    m = "down_blocks.0.motion_modules.0.temporal_transformer.transformer_blocks.0." \
        "attention_blocks.0."
    base = _seeded([(m + "to_q.weight", (8, 8)), (m + "to_out.0.weight", (8, 8)),
                    (m + "to_out.0.bias", (8,))], 5)
    lora = _seeded([(m + "processor.to_q_lora.down.weight", (2, 8)),
                    (m + "processor.to_q_lora.up.weight", (8, 2)),
                    (m + "processor.to_out_lora.down.weight", (2, 8)),
                    (m + "processor.to_out_lora.up.weight", (8, 2))], 6)
    got, want = t_ldm.merge_motion_lora(
        {k: torch.from_numpy(v) for k, v in base.items()},
        {k: torch.from_numpy(v) for k, v in lora.items()}, alpha=0.8), \
        j_ldm.merge_motion_lora(base, lora, alpha=0.8)
    _same(got, want)
