"""The SD3 text encoders: CLIP (L and G) and the T5-XXL encoder, with the
prompt tokenizers and the layer-selection wrappers (counterpart of the
reference ``models/text_encoders.py``).

The modules own the weights under the reference checkpoint's names
(``text_model.encoder.layers.{i}.self_attn.q_proj.weight``,
``encoder.block.{i}.layer.1.DenseReluDense.wi_0.weight`` ...); the
functions, named as in the reference, do the work. Every attention is plain
fp32-softmax ``sdpa``: CLIP's under a causal mask, T5's under its
relative-position bias, which is computed once and shared by every block.
The tokenizers take any HF-style tokenizer callable (``tok(text)
["input_ids"]``); no vocabulary ships with the repository.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from selftoktokenizer_tpu_torch.models.encoder import RMSNormWeight
from selftoktokenizer_tpu_torch.ops.attention import mha
from selftoktokenizer_tpu_torch.ops.linear import linear_apply as _lin
from selftoktokenizer_tpu_torch.ops.norms import layer_norm, rms_norm


# ---------------------------------------------------------------------------
# CLIP
# ---------------------------------------------------------------------------

ACTIVATIONS = {
    "quick_gelu": lambda a: a * torch.sigmoid(1.702 * a),
    "gelu": lambda a: F.gelu(a),
}


@dataclasses.dataclass
class CLIPTextConfig:
    """The HF config fields the reference's CLIPTextModel_ reads."""
    num_hidden_layers: int = 12
    hidden_size: int = 768
    num_attention_heads: int = 12
    intermediate_size: int = 3072
    hidden_act: str = "quick_gelu"
    vocab_size: int = 49408
    num_positions: int = 77


class CLIPAttention(nn.Module):
    def __init__(self, D):
        super().__init__()
        self.q_proj = nn.Linear(D, D)
        self.k_proj = nn.Linear(D, D)
        self.v_proj = nn.Linear(D, D)
        self.out_proj = nn.Linear(D, D)


class CLIPMlp(nn.Module):
    def __init__(self, D, hidden):
        super().__init__()
        self.fc1 = nn.Linear(D, hidden)
        self.fc2 = nn.Linear(hidden, D)


class CLIPLayer(nn.Module):
    def __init__(self, cfg: CLIPTextConfig):
        super().__init__()
        D = cfg.hidden_size
        self.layer_norm1 = nn.LayerNorm(D)
        self.self_attn = CLIPAttention(D)
        self.layer_norm2 = nn.LayerNorm(D)
        self.mlp = CLIPMlp(D, cfg.intermediate_size)


class CLIPEmbeddings(nn.Module):
    def __init__(self, cfg: CLIPTextConfig):
        super().__init__()
        self.token_embedding = nn.Embedding(cfg.vocab_size, cfg.hidden_size)
        self.position_embedding = nn.Embedding(cfg.num_positions, cfg.hidden_size)


class CLIPEncoder(nn.Module):
    def __init__(self, cfg: CLIPTextConfig):
        super().__init__()
        self.layers = nn.ModuleList(CLIPLayer(cfg) for _ in range(cfg.num_hidden_layers))


class CLIPTextTransformer(nn.Module):
    def __init__(self, cfg: CLIPTextConfig):
        super().__init__()
        self.embeddings = CLIPEmbeddings(cfg)
        self.encoder = CLIPEncoder(cfg)
        self.final_layer_norm = nn.LayerNorm(cfg.hidden_size)


class CLIPTextModel(nn.Module):
    """``text_model.*`` and the bias-free ``text_projection``."""

    def __init__(self, cfg: CLIPTextConfig):
        super().__init__()
        self.cfg = cfg
        self.text_model = CLIPTextTransformer(cfg)
        self.text_projection = nn.Linear(cfg.hidden_size, cfg.hidden_size, bias=False)


def _ln5(m: nn.LayerNorm, x):
    return layer_norm(x, m.weight, m.bias, eps=1e-5)


def clip_layer_apply(p: CLIPLayer, cfg: CLIPTextConfig, x, mask):
    """The pre-LN CLIP layer; LayerNorm eps 1e-5 (torch's default), unlike
    the 1e-6 of the rest of the port."""
    h = _ln5(p.layer_norm1, x)
    a = p.self_attn
    x = x + _lin(a.out_proj, mha(_lin(a.q_proj, h), _lin(a.k_proj, h), _lin(a.v_proj, h),
                                 cfg.num_attention_heads, mask=mask))
    h = ACTIVATIONS[cfg.hidden_act](_lin(p.mlp.fc1, _ln5(p.layer_norm2, x)))
    return x + _lin(p.mlp.fc2, h)


def _layers(blocks, body, x, intermediate_output):
    """Every block in turn; also the hidden state after block
    ``intermediate_output`` (negative: counted from the end)."""
    io = intermediate_output
    if io is not None and io < 0:
        io = len(blocks) + io
    inter = None
    for i, bp in enumerate(blocks):
        x = body(bp, x)
        if i == io:
            inter = x
    return x, inter


def clip_text_apply(params: CLIPTextModel, cfg: CLIPTextConfig, tokens,
                    intermediate_output: Optional[int] = None,
                    final_layer_norm_intermediate: bool = True):
    """tokens: [B, L] int. Returns (last hidden, intermediate, projected
    pooled, raw pooled); pooling takes each row's position of its largest
    token id (the end token)."""
    tm = params.text_model
    L = tokens.shape[1]
    x = tm.embeddings.token_embedding.weight[tokens] + tm.embeddings.position_embedding.weight[:L]
    causal = torch.triu(torch.full((L, L), float("-inf"), device=x.device), diagonal=1)
    x, inter = _layers(tm.encoder.layers, lambda bp, h: clip_layer_apply(bp, cfg, h, causal), x,
                       intermediate_output)
    x = _ln5(tm.final_layer_norm, x)
    if inter is not None and final_layer_norm_intermediate:
        inter = _ln5(tm.final_layer_norm, inter)
    pooled = x[torch.arange(x.shape[0], device=x.device), torch.argmax(tokens, dim=-1)]
    return x, inter, _lin(params.text_projection, pooled), pooled


# ---------------------------------------------------------------------------
# T5-XXL encoder
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class T5Config:
    """The HF config fields the reference's T5 reads (inner dim = d_model)."""
    num_layers: int = 24
    d_model: int = 4096
    d_ff: int = 10240
    num_heads: int = 64
    vocab_size: int = 32128
    relative_attention_num_buckets: int = 32
    relative_attention_max_distance: int = 128


class T5Attention(nn.Module):
    def __init__(self, cfg: T5Config, relative_bias):
        super().__init__()
        D = cfg.d_model
        self.q = nn.Linear(D, D, bias=False)
        self.k = nn.Linear(D, D, bias=False)
        self.v = nn.Linear(D, D, bias=False)
        self.o = nn.Linear(D, D, bias=False)
        if relative_bias:
            self.relative_attention_bias = nn.Embedding(cfg.relative_attention_num_buckets,
                                                        cfg.num_heads)


class T5LayerSelfAttention(nn.Module):
    def __init__(self, cfg: T5Config, relative_bias):
        super().__init__()
        self.SelfAttention = T5Attention(cfg, relative_bias)
        self.layer_norm = RMSNormWeight(cfg.d_model)


class T5DenseGatedAct(nn.Module):
    def __init__(self, cfg: T5Config):
        super().__init__()
        self.wi_0 = nn.Linear(cfg.d_model, cfg.d_ff, bias=False)
        self.wi_1 = nn.Linear(cfg.d_model, cfg.d_ff, bias=False)
        self.wo = nn.Linear(cfg.d_ff, cfg.d_model, bias=False)


class T5LayerFF(nn.Module):
    def __init__(self, cfg: T5Config):
        super().__init__()
        self.DenseReluDense = T5DenseGatedAct(cfg)
        self.layer_norm = RMSNormWeight(cfg.d_model)


class T5Block(nn.Module):
    def __init__(self, cfg: T5Config, relative_bias):
        super().__init__()
        self.layer = nn.ModuleList([T5LayerSelfAttention(cfg, relative_bias), T5LayerFF(cfg)])


class T5Stack(nn.Module):
    def __init__(self, cfg: T5Config):
        super().__init__()
        self.embed_tokens = nn.Embedding(cfg.vocab_size, cfg.d_model)
        self.block = nn.ModuleList(T5Block(cfg, relative_bias=i == 0)
                                   for i in range(cfg.num_layers))
        self.final_layer_norm = RMSNormWeight(cfg.d_model)


class T5(nn.Module):
    """``encoder.*``: the T5-XXL encoder stack; block 0 owns the relative
    position bias table."""

    def __init__(self, cfg: T5Config):
        super().__init__()
        self.cfg = cfg
        self.encoder = T5Stack(cfg)


def t5_relative_position_bucket(relative_position, num_buckets=32, max_distance=128):
    """The bidirectional mesh-TF bucket of each relative position."""
    num_buckets //= 2
    rel_buckets = (relative_position > 0).to(torch.int64) * num_buckets
    rp = torch.abs(relative_position)
    max_exact = num_buckets // 2
    is_small = rp < max_exact
    rp_large = max_exact + (torch.log(rp.to(torch.float32) / max_exact)
                            / math.log(max_distance / max_exact)
                            * (num_buckets - max_exact)).to(torch.int64)
    rp_large = torch.clamp(rp_large, max=num_buckets - 1)
    return rel_buckets + torch.where(is_small, rp, rp_large)


def t5_compute_bias(bias_table, cfg: T5Config, length):
    """The additive attention bias [1, H, L, L]."""
    pos = torch.arange(length, device=bias_table.device)
    buckets = t5_relative_position_bucket(pos[None, :] - pos[:, None],
                                          cfg.relative_attention_num_buckets,
                                          cfg.relative_attention_max_distance)
    return bias_table[buckets].permute(2, 0, 1)[None]


def t5_block_apply(p: T5Block, cfg: T5Config, x, bias):
    """Self-attention and the gated tanh-GELU feed-forward, both after an
    RMSNorm. No attention scaling: k is multiplied by sqrt(head_dim) to
    cancel the 1/sqrt(head_dim) of sdpa."""
    sa, ff = p.layer[0], p.layer[1]
    h = rms_norm(x, sa.layer_norm.weight)
    a = sa.SelfAttention
    k = _lin(a.k, h)
    head_dim = k.shape[-1] // cfg.num_heads
    attn = mha(_lin(a.q, h), k * math.sqrt(head_dim), _lin(a.v, h), cfg.num_heads, mask=bias)
    x = x + _lin(a.o, attn)
    h = rms_norm(x, ff.layer_norm.weight)
    d = ff.DenseReluDense
    g = F.gelu(_lin(d.wi_0, h), approximate="tanh")
    return x + _lin(d.wo, g * _lin(d.wi_1, h))


def t5_apply(params: T5, cfg: T5Config, tokens, intermediate_output: Optional[int] = None,
             final_layer_norm_intermediate: bool = True):
    """tokens: [B, L] int. The relative bias is computed once (from block
    0's table) and shared by every block. Returns (last hidden,
    intermediate)."""
    st = params.encoder
    x = st.embed_tokens.weight[tokens]
    bias = t5_compute_bias(st.block[0].layer[0].SelfAttention.relative_attention_bias.weight,
                           cfg, tokens.shape[1]).to(x.dtype)
    x, inter = _layers(st.block, lambda bp, h: t5_block_apply(bp, cfg, h, bias), x,
                       intermediate_output)
    x = rms_norm(x, st.final_layer_norm.weight)
    if inter is not None and final_layer_norm_intermediate:
        inter = rms_norm(inter, st.final_layer_norm.weight)
    return x, inter


# ---------------------------------------------------------------------------
# prompt tokenizers and the SD-CLIP wrappers
# ---------------------------------------------------------------------------

class SDTokenizer:
    """A prompt -> one list of (token, weight) pairs. ``tokenizer`` is any
    HF-style tokenizer callable, ``tokenizer(text)["input_ids"]``."""

    def __init__(self, max_length=77, pad_with_end=True, tokenizer=None, has_start_token=True,
                 pad_to_max_length=True, min_length=None):
        self.tokenizer = tokenizer
        self.max_length = max_length
        self.min_length = min_length
        empty = self.tokenizer("")["input_ids"]
        if has_start_token:
            self.tokens_start = 1
            self.start_token = empty[0]
            self.end_token = empty[1]
        else:
            self.tokens_start = 0
            self.start_token = None
            self.end_token = empty[0]
        self.pad_with_end = pad_with_end
        self.pad_to_max_length = pad_to_max_length

    def tokenize_with_weights(self, text: str):
        pad_token = self.end_token if self.pad_with_end else 0
        batch = []
        if self.start_token is not None:
            batch.append((self.start_token, 1.0))
        words = [w for w in text.replace("\n", " ").split(" ") if w != ""]
        for word in words:
            batch.extend((t, 1.0) for t in self.tokenizer(word)["input_ids"][self.tokens_start:-1])
        batch.append((self.end_token, 1.0))
        if self.pad_to_max_length:
            batch.extend([(pad_token, 1.0)] * (self.max_length - len(batch)))
        if self.min_length is not None and len(batch) < self.min_length:
            batch.extend([(pad_token, 1.0)] * (self.min_length - len(batch)))
        return [batch]


class SD3Tokenizer:
    """The three encoders' tokenization: CLIP-L, CLIP-G (padded with 0, not
    the end token) and T5-XXL (no start token, at least 77, no maximum)."""

    def __init__(self, clip_tokenizer, t5_tokenizer):
        self.clip_l = SDTokenizer(tokenizer=clip_tokenizer)
        self.clip_g = SDTokenizer(pad_with_end=False, tokenizer=clip_tokenizer)
        self.t5xxl = SDTokenizer(pad_with_end=False, tokenizer=t5_tokenizer,
                                 has_start_token=False, pad_to_max_length=False,
                                 max_length=99999999, min_length=77)

    def tokenize_with_weights(self, text: str):
        return {"g": self.clip_g.tokenize_with_weights(text),
                "l": self.clip_l.tokenize_with_weights(text),
                "t5xxl": self.t5xxl.tokenize_with_weights(text)}


class SDClipModel:
    """Layer selection over a text transformer: layer 'last' or 'hidden'
    (``layer_idx``), the final norm on the intermediate or not, the
    projected or the raw pooled output. ``params`` is the model's module
    (``CLIPTextModel`` or ``T5``)."""

    LAYERS = ("last", "pooled", "hidden")

    def __init__(self, params, cfg, layer="last", layer_idx=None, model_apply=clip_text_apply,
                 num_layers=None, layer_norm_hidden_state=True, return_projected_pooled=True):
        assert layer in self.LAYERS
        self.params, self.cfg = params, cfg
        self.apply = model_apply
        self.num_layers = (num_layers if num_layers is not None
                           else getattr(cfg, "num_hidden_layers", getattr(cfg, "num_layers", None)))
        self.layer, self.layer_idx = layer, None
        self.layer_norm_hidden_state = layer_norm_hidden_state
        self.return_projected_pooled = return_projected_pooled
        if layer == "hidden":
            assert layer_idx is not None and abs(layer_idx) < self.num_layers
            self.set_clip_options({"layer": layer_idx})

    def set_clip_options(self, options):
        layer_idx = options.get("layer", self.layer_idx)
        self.return_projected_pooled = options.get("projected_pooled",
                                                   self.return_projected_pooled)
        if layer_idx is None or abs(layer_idx) > self.num_layers:
            self.layer = "last"
        else:
            self.layer, self.layer_idx = "hidden", layer_idx

    def __call__(self, tokens):
        dev = next(self.params.parameters()).device
        tokens = torch.as_tensor(tokens, dtype=torch.int64, device=dev)
        outputs = self.apply(self.params, self.cfg, tokens, intermediate_output=self.layer_idx,
                             final_layer_norm_intermediate=self.layer_norm_hidden_state)
        z = outputs[0] if self.layer == "last" else outputs[1]
        pooled = None
        if len(outputs) >= 3:
            if (not self.return_projected_pooled and len(outputs) >= 4
                    and outputs[3] is not None):
                pooled = outputs[3].float()
            elif outputs[2] is not None:
                pooled = outputs[2].float()
        return z.float(), pooled

    def encode_token_weights(self, token_weight_pairs):
        """The weights are carried but unused (all 1.0), as in the reference."""
        tokens = [t for t, _ in token_weight_pairs[0]]
        out, pooled = self([tokens])
        return out[0:1], pooled[0:1] if pooled is not None else None


def sdxl_clip_g(params, cfg, layer="penultimate"):
    """CLIP-G as SDXL uses it: the penultimate hidden layer, without the
    final norm on it."""
    if layer == "penultimate":
        layer, layer_idx = "hidden", -2
    else:
        layer_idx = None
    return SDClipModel(params, cfg, layer=layer, layer_idx=layer_idx,
                       layer_norm_hidden_state=False)


def t5xxl_model(params, cfg: T5Config, layer="last", layer_idx=None):
    return SDClipModel(params, cfg, layer=layer, layer_idx=layer_idx, model_apply=t5_apply,
                       num_layers=cfg.num_layers)
