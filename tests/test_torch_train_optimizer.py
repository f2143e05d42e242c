"""The optimizer of the port's trainer on the CPU: AdamW over the two
learning-rate groups (``dit_lr`` for ``model.*``, ``token_lr`` for the
rest) with one global clip before the step, fed the JAX package's own
tokenizer-loss gradients (scaled to either side of the clip) beside its
optax optimizer (``make_optimizer``) for 3 steps, with warmup, weight decay
and a cosine schedule; and the schedules themselves.
Gradients are fed, not computed: Adam normalises each update, so a leaf
whose gradient is near 0 would move by +-lr on a gradient difference of
1e-9. Parameters after 3 steps within 1e-6."""

import dataclasses

import numpy as np
import jax
import jax.numpy as jnp

from selftoktokenizer_tpu.core.config import load_config as j_load_config
from selftoktokenizer_tpu.models import tokenizer as j_tok
from selftoktokenizer_tpu.models import vq as j_vq
from selftoktokenizer_tpu.train import trainer as j_trainer
from selftoktokenizer_tpu_torch.core import convert
from selftoktokenizer_tpu_torch.models import tokenizer as t_tok
from selftoktokenizer_tpu_torch.train import trainer as t_trainer
from tests.torch_port_helpers import (
    TINY, encoder_tables, jax_tree, mmdit_tables, seeded_tree, to_np)

FROZEN = "encoder.quantizer._codebook.embed"    # moved by EMA, not by gradients


def _tiny():
    params = j_load_config(TINY).to_dict()["tokenizer"]["params"]
    jtc = j_tok.tokenizer_config_from_params(params)
    tree = seeded_tree(lambda k: j_tok.tokenizer_init(k, jtc), 5,
                       {**encoder_tables(jtc.encoder, ("encoder",)),
                        **mmdit_tables(jtc.decoder, ("model",))})
    return t_tok.tokenizer_config_from_params(params), jtc, tree


def test_optimizer_fed_the_same_grads_matches_optax():
    ttc, jtc, tree = _tiny()
    tc = j_trainer.TrainConfig(dit_lr=1e-3, token_lr=3e-3, warmup_steps=2, max_steps=6,
                               grad_norm=1.0, weight_decay=0.01, schedule="cosine")
    jp = jax_tree(tree)
    opt = j_trainer.make_optimizer(jp, tc)
    opt_state = opt.init(jp)
    x = jnp.asarray(np.random.default_rng(0).standard_normal((4, 8, 8, 16)), jnp.float32)
    vq_state = j_vq.vq_state_init(jp["encoder"]["quantizer"], jtc.k)

    @jax.jit
    def j_grads(params):
        # the reference's own gradients at its parameters of the step
        return jax.grad(lambda p: j_tok.tokenizer_loss(
            p, jtc, x, jax.random.PRNGKey(3), vq_state=vq_state)[0])(params)

    @jax.jit
    def j_step(grads, opt_state, params):
        updates, opt_state = opt.update(grads, opt_state, params)
        return (jax.tree_util.tree_map(lambda p, u: p + u, params, updates), opt_state,
                j_trainer.optax.global_norm(grads))

    tok = convert.tokenizer_from_jax_tree(tree, ttc)
    t_tc = t_trainer.TrainConfig(**dataclasses.asdict(tc))
    t_opt = t_trainer.make_optimizer(tok, t_tc)
    assert [g["lr"] for g in t_opt.param_groups] == [1e-3, 3e-3]
    params = [p for _, p in t_trainer._trainable(tok)]
    # scaled so the global norm is under the clip once and over it twice
    norms = []
    for step, scale in enumerate((1e-2, 30.0, 1.0)):
        grads = jax.tree_util.tree_map(lambda g: np.asarray(g) * np.float32(scale), j_grads(jp))
        jp, opt_state, j_norm = j_step(grads, opt_state, jp)
        gsd = convert.tokenizer_state_dict(grads, ttc)
        for n, p in t_trainer._trainable(tok):
            p.grad = gsd[n].clone()
        norm = t_trainer.apply_update(t_opt, params, t_tc, step)
        np.testing.assert_allclose(float(norm), float(j_norm), rtol=1e-5)
        norms.append(float(norm))
    assert norms[0] < 1.0 < norms[1]
    want = convert.tokenizer_state_dict(jax.tree_util.tree_map(np.asarray, jp), ttc)
    for n, p in tok.named_parameters():
        if n != FROZEN:
            np.testing.assert_allclose(to_np(p), want[n].numpy(), rtol=1e-6, atol=1e-7, err_msg=n)


def test_lr_schedules_match_optax():
    for kw in (dict(warmup_steps=3), dict(schedule="cosine", warmup_steps=2, max_steps=9),
               dict(schedule="linear", max_steps=7), dict(schedule="cosine", max_steps=5)):
        tc = j_trainer.TrainConfig(**kw)
        sched = j_trainer._lr_schedule(2e-3, tc)
        for step in range(12):
            want = float(sched(step)) if callable(sched) else sched
            got = t_trainer.lr_at(2e-3, t_trainer.TrainConfig(**kw), step)
            np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-12, err_msg=f"{kw} {step}")
