"""Single-file (LDM) checkpoints and LoRA weights, as dicts of torch tensors
(counterpart of the reference ``core/ldm_convert.py``).

Every function maps a flat state dict to a flat state dict:

- ``ldm_vae_state_dict``: the VAE's weights of an LDM checkpoint, with the
  ``first_stage_model.`` prefix taken off (the VAE reads LDM names as they
  are).
- ``ldm_clip_state_dict``: an SD1.x CLIP text encoder, already in HF names.
- ``open_clip_state_dict``: an SD2.x open-CLIP text encoder renamed to HF
  names, its fused ``in_proj`` split into q / k / v.
- ``merge_lora`` / ``merge_motion_lora``: ``W += alpha * up @ down`` into a
  copy of the base dict.
"""

from __future__ import annotations

import re

import torch


def _t(v):
    return v if torch.is_tensor(v) else torch.as_tensor(v)


def ldm_vae_state_dict(checkpoint):
    """The VAE's weights of an LDM single-file checkpoint."""
    pre = "first_stage_model."
    return {k[len(pre):]: v for k, v in checkpoint.items() if k.startswith(pre)}


def ldm_clip_state_dict(checkpoint):
    """An SD1.x CLIP text encoder: the HF-named weights under
    ``cond_stage_model.transformer.``, without the position_ids buffer."""
    pre = "cond_stage_model.transformer."
    out = {}
    for k, v in checkpoint.items():
        if k == pre + "text_model.embeddings.position_ids":
            continue
        if k.startswith(pre):
            out[k[len(pre):]] = v
    return out


_TEXTENC_CONVERSION = {
    "cond_stage_model.model.positional_embedding":
        "text_model.embeddings.position_embedding.weight",
    "cond_stage_model.model.token_embedding.weight":
        "text_model.embeddings.token_embedding.weight",
    "cond_stage_model.model.ln_final.weight": "text_model.final_layer_norm.weight",
    "cond_stage_model.model.ln_final.bias": "text_model.final_layer_norm.bias",
}
_TRANSFORMER_RENAMES = [
    ("resblocks.", "text_model.encoder.layers."),
    ("ln_1", "layer_norm1"),
    ("ln_2", "layer_norm2"),
    (".c_fc.", ".fc1."),
    (".c_proj.", ".fc2."),
    (".attn", ".self_attn"),
    ("ln_final.", "transformer.text_model.final_layer_norm."),
    ("token_embedding.weight", "transformer.text_model.embeddings.token_embedding.weight"),
    ("positional_embedding", "transformer.text_model.embeddings.position_embedding.weight"),
]
_TEXTENC_PATTERN = re.compile("|".join(re.escape(a) for a, _ in _TRANSFORMER_RENAMES))
_TEXTENC_PROTECTED = dict(_TRANSFORMER_RENAMES)


def _rename(s):
    return _TEXTENC_PATTERN.sub(lambda m: _TEXTENC_PROTECTED[m.group(0)], s)


def open_clip_state_dict(checkpoint, num_hidden_layers=23):
    """An SD2.x open-CLIP text encoder in HF names: resblocks renamed, the
    fused ``in_proj_weight`` / ``in_proj_bias`` split into q, k, v. The
    layer ``resblocks.{num_hidden_layers}.`` is dropped (the reference
    always drops 23: diffusers keeps 23 of open-CLIP's 24 layers); the
    match is on that exact index."""
    if "cond_stage_model.model.text_projection" in checkpoint:
        d_model = int(_t(checkpoint["cond_stage_model.model.text_projection"]).shape[0])
    else:
        d_model = 1024
    pre = "cond_stage_model.model.transformer."
    out = {}
    for k, v in checkpoint.items():
        if f"resblocks.{num_hidden_layers}." in k:
            continue
        if k in _TEXTENC_CONVERSION:
            out[_TEXTENC_CONVERSION[k]] = v
        if not k.startswith(pre):
            continue
        nk = k[len(pre):]
        for suffix, part in ((".in_proj_weight", "weight"), (".in_proj_bias", "bias")):
            if nk.endswith(suffix):
                base = _rename(nk[: -len(suffix)])
                w = _t(v)
                for i, n in enumerate(("q_proj", "k_proj", "v_proj")):
                    out[f"{base}.{n}.{part}"] = w[d_model * i: d_model * (i + 1)]
                break
        else:
            out[_rename(nk)] = v
    return out


def _resolve_lora_key(parts, keys):
    """The base key a LoRA key names. LoRA keys flatten module paths with
    ``_``, so ``down_blocks`` arrives as two tokens: a token starts a new
    path segment when some base key continues from the segments so far, else
    it is glued onto the pending one."""
    segs, pending = [], parts[0]
    for tok in parts[1:]:
        cand = ".".join(segs + [pending])
        if any(k == cand + ".weight" or k.startswith(cand + ".") for k in keys):
            segs.append(pending)
            pending = tok
        else:
            pending = pending + "_" + tok
    segs.append(pending)
    return ".".join(segs) + ".weight"


def merge_lora(base_sd, lora_sd, alpha=0.6, prefix_unet="lora_unet", prefix_te="lora_te"):
    """A Kohya-style LoRA merged into a copy of a flat base state dict:
    ``W += alpha * up @ down`` (a conv LoRA's 1x1 kernels squeezed for the
    product and restored after), in float32. Keys holding "text" name the
    text encoder's weights, the rest the denoiser's."""
    out = {k: _t(v).clone() for k, v in base_sd.items()}
    visited = set()
    for key in lora_sd:
        if ".alpha" in key or key in visited:
            continue
        prefix = prefix_te if "text" in key else prefix_unet
        flat = key.split(".")[0].split(prefix + "_")[-1]
        target = _resolve_lora_key(flat.split("_"), out.keys())
        if "lora_down" in key:
            up_key, down_key = key.replace("lora_down", "lora_up"), key
        else:
            up_key, down_key = key, key.replace("lora_up", "lora_down")
        up = _t(lora_sd[up_key]).float()
        down = _t(lora_sd[down_key]).float()
        if up.ndim == 4:
            delta = (up[:, :, 0, 0] @ down[:, :, 0, 0])[..., None, None]
        else:
            delta = up @ down
        out[target] = out[target] + alpha * delta.to(out[target].dtype)
        visited.update((up_key, down_key))
    return out


def merge_motion_lora(base_sd, lora_sd, alpha=1.0):
    """An AnimateDiff motion LoRA merged into a copy of a flat base state
    dict: dot-path keys with ``processor.`` / ``_lora`` / ``down.`` /
    ``up.`` markers, ``to_out.`` -> ``to_out.0.``; ``W += alpha * up @
    down``."""
    out = {k: _t(v).clone() for k, v in base_sd.items()}
    for key in lora_sd:
        if "up." in key:
            continue
        up_key = key.replace(".down.", ".up.")
        model_key = (key.replace("processor.", "").replace("_lora", "").replace("down.", "")
                     .replace("up.", "").replace("to_out.", "to_out.0."))
        target = model_key.rsplit(".", 1)[0] + ".weight"
        up = _t(lora_sd[up_key]).float()
        down = _t(lora_sd[key]).float()
        out[target] = out[target] + alpha * (up @ down).to(out[target].dtype)
    return out
