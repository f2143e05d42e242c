"""The renderer's loss graphs on the CPU, against the JAX package's on the
same carried seeded weights and numpy latents: ``renderer_loss`` (the
ImageRenderer forward: every token active, one pass), and
``renderer_train_step`` over a frozen encoder (loss, batch perplexity, every
grad of the renderer within 1e-4 of its leaf's largest magnitude)."""

import numpy as np
import torch
import jax
import jax.numpy as jnp

from selftoktokenizer_tpu.core.config import load_config as j_load_config
from selftoktokenizer_tpu.models import tokenizer as j_tok
from selftoktokenizer_tpu_torch.core import convert
from selftoktokenizer_tpu_torch.models import tokenizer as t_tok
from selftoktokenizer_tpu_torch.train import trainer as t_trainer
from tests.torch_port_helpers import (
    TINY, encoder_tables, jax_tree, mmdit_tables, seeded_tree, to_np)

# fp32 on both sides through 2 joint blocks of width 128: summation order only
TOL = dict(rtol=1e-4, atol=1e-4)
GRAD_TOL = 1e-4


def _configs():
    params = j_load_config(TINY).to_dict()["tokenizer"]["params"]
    params["model"] = "MMDiT_XL_Renderer"
    params["decoder_config"]["repeat"] = True
    return t_tok.tokenizer_config_from_params(params), j_tok.tokenizer_config_from_params(params)


def _tree(jtc, seed):
    return seeded_tree(lambda k: j_tok.tokenizer_init(k, jtc), seed,
                       {**encoder_tables(jtc.encoder, ("encoder",)),
                        **mmdit_tables(jtc.decoder, ("model",))})


def test_renderer_loss_forward():
    ttc, jtc = _configs()
    tree = _tree(jtc, 19)
    x = np.random.default_rng(6).standard_normal((2, 8, 8, 16)).astype(np.float32)
    want = jax.jit(lambda p: j_tok.renderer_loss(p, jtc, jnp.asarray(x)))(jax_tree(tree))
    tok = convert.tokenizer_from_jax_tree(tree, ttc).requires_grad_(False)
    got = t_tok.renderer_loss(tok, ttc, torch.from_numpy(x))
    np.testing.assert_array_equal(to_np(got[0]), to_np(want[0]))
    for g, w in zip(got[1:], want[1:]):
        assert tuple(g.shape) == tuple(w.shape)
        np.testing.assert_allclose(to_np(g), to_np(w), **TOL)


def test_renderer_train_step_with_the_encoder_frozen():
    ttc, jtc = _configs()
    tree = _tree(jtc, 8)
    x = np.random.default_rng(5).standard_normal((2, 8, 8, 16)).astype(np.float32)
    jp = jax_tree(tree)
    (j_loss, j_logs), j_grads = jax.jit(jax.value_and_grad(
        lambda mp: j_tok.renderer_train_loss(mp, jp["encoder"], jtc, jnp.asarray(x)),
        has_aux=True))(jp["model"])
    tok = convert.tokenizer_from_jax_tree(tree, ttc)
    tok.encoder.requires_grad_(False)
    enc_before = {n: p.clone() for n, p in tok.encoder.named_parameters()}
    model_before = {n: p.detach().clone() for n, p in tok.model.named_parameters()}
    tc = t_trainer.TrainConfig(dit_lr=1e-3)
    state = t_trainer.make_renderer_train_state(tok.model, tc)
    state, logs = t_trainer.renderer_train_step(state, ttc, tc, tok.encoder, torch.from_numpy(x))

    np.testing.assert_allclose(float(logs["loss"]), float(j_loss), rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(float(logs["batch_perplexity"]), float(j_logs["batch_perplexity"]),
                               rtol=1e-5, atol=1e-6)
    gsd = {"model." + k: v for k, v in convert.mmdit_state_dict(
        jax.tree_util.tree_map(np.asarray, j_grads), ttc.decoder).items()}
    for n, p in tok.model.named_parameters():
        want = gsd["model." + n].numpy()
        err, scale = np.abs(to_np(p.grad) - want).max(), np.abs(want).max()
        assert err <= GRAD_TOL * scale or err <= 1e-10, (n, err, scale)
    assert state.step == 1 and len(state.opt.param_groups) == 1
    for n, p in tok.encoder.named_parameters():
        assert p.grad is None and torch.equal(p, enc_before[n]), n
    assert any(not torch.equal(p, model_before[n]) for n, p in tok.model.named_parameters())
