"""A trained tokenizer -> the reference-named state dict (counterpart of the
reference ``core/export.py``, the reverse converter).

The port's modules already carry the reference's names (``encoder.*`` and
``model.*`` of an ``ImageTokenizer``, the MMDiT's ``joint_blocks.{i}.*``),
so the export is assembly: the module's tensors, with the quantizer's EMA
state written as the reference ``VectorQuantize`` buffers. The result loads
into the unmodified reference and into the port's ``SelftokPipeline``, and
equals what the JAX exporter (``tokenizer_to_state_dict``) emits for the
same weights: the same names, shapes and fp32 values.

* ``tokenizer_to_state_dict(tok, vq_state, params=None)``: an
  ``ImageTokenizer`` (or an encoder-only / renderer one); ``params`` is a
  {name: tensor} of the module's parameter names that replaces their values
  (the train state's EMA copy).
* ``train_state_to_state_dict(raw, ema=False)``: a ``save_train_state``
  file's contents (or a renderer trainer's checkpoint) -> the state dict of
  its live weights, or of its EMA copy (the reference's ``ema_state_dict``
  payload).
"""

from __future__ import annotations

from selftoktokenizer_tpu_torch.models import vq as vq_mod

Q = "encoder.quantizer."


def vq_to_state_dict(vq_state: vq_mod.VQState, K=None):
    """The quantizer's EMA state as the reference ``VectorQuantize`` buffers
    (names relative to the quantizer; the num_codebooks=1 leading axis).
    The reference keeps a second, pre-reactivation cluster counter for its
    logs; the state keeps one, written under both names. The per-position
    usage table is written only when it has K rows."""
    out = vq_mod.vq_state_to_state_dict(vq_state)
    out["_codebook.cluster_size_wo_react"] = out["_codebook.cluster_size"]
    if K is not None and vq_state.timestep_p_over_c.shape[0] != K:
        del out["_codebook.timestep_p_over_c"], out["_codebook.tpc_initted"]
    return out


def _fp32_cpu(t):
    t = t.detach().cpu()
    return t.float().contiguous() if t.is_floating_point() else t.contiguous()


def _assemble(sd, vq_state, K):
    out = {k: _fp32_cpu(v) for k, v in sd.items()}
    if vq_state is not None:
        for k, v in vq_to_state_dict(vq_state, K).items():
            out[Q + k] = _fp32_cpu(v)
    return out


def _with_params(sd, params, what):
    sd = dict(sd)
    for k, v in (params or {}).items():
        if k not in sd:
            raise KeyError(f"{what} has {k}, which the weights lack")
        sd[k] = v
    return sd


def tokenizer_to_state_dict(tok, vq_state=None, params=None):
    """{reference name: CPU tensor} of ``tok`` (``encoder.*`` and, when the
    module has a decoder, ``model.*``), floating tensors in fp32.

    vq_state: the quantizer's EMA state; its codebook is the one exported
    (the authoritative copy, which a train step writes into the module)
    and its buffers join the dict. Without it only the module's codebook
    goes out. params: {parameter name: tensor} replacing the module's values
    of those names (an EMA copy)."""
    sd = _with_params(tok.state_dict(), params, "params")
    return _assemble(sd, vq_state, tok.encoder.cfg.K)


def train_state_to_state_dict(raw, ema=False, K=None):
    """The contents of a ``save_train_state`` file (or of the renderer
    trainer's checkpoint: ``params``, optional ``ema_params`` and
    ``vq_state``) -> the reference-named state dict of its live weights, or
    with ``ema`` of its EMA copy; the codebook and the VQ buffers are the
    state's in both, as the JAX exporter writes them. K: the encoder's
    token count (the usage table is written only when it has K rows; None
    writes it as it is)."""
    if ema and raw.get("ema_params") is None:
        raise KeyError("the checkpoint holds no ema_params")
    sd = _with_params(raw["params"], raw["ema_params"] if ema else None, "ema_params")
    vq = raw.get("vq_state")
    return _assemble(sd, None if vq is None else vq_mod.VQState(**vq), K)

