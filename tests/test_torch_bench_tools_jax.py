"""Two measurement tools' computations against the JAX package on the CPU,
on the same carried seeded weights (non-zero everywhere):

* ``bench_train``: one rematerialised tokenizer train step (the encoder's
  ``gradient_checkpointing`` and the decoder's ``use_checkpoint``, the
  config changed as the tool changes it, at the tiny width) against JAX's
  ``train_step`` with the same change, fed the draws JAX makes from its
  key: the loss and log dict within 1e-5 relative, the ids equal, and each
  gradient leaf within 1e-4 of its largest magnitude against JAX's
  gradients of the same loss (tests/test_torch_train.py's tolerances);
* ``measure_k1024``: the encode of its K=1024 config (``k1024_config``)
  against the JAX pipeline's ids on the same images, by the 1e-6 top-2
  margin rule."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import torch

from selftoktokenizer_tpu.core.config import load_config as j_load_config
from selftoktokenizer_tpu.models import tokenizer as j_tok
from selftoktokenizer_tpu.models import vq as j_vq
from selftoktokenizer_tpu.train import trainer as j_trainer
from selftoktokenizer_tpu_torch.core import convert
from selftoktokenizer_tpu_torch.models.tokenizer import tokenizer_config_from_params
from selftoktokenizer_tpu_torch.tools import bench_train, measure_k1024
from selftoktokenizer_tpu_torch.train import trainer as t_trainer
from tests.torch_port_helpers import (
    TINY, encoder_tables, jax_step_draws, jax_tree, mmdit_tables, pipeline_pair, seeded_tree,
    to_np)

B = 4
DEPTH = 2          # the tiny decoder's own depth: width 128
GRAD_TOL = 1e-4
VQ_MARGIN = 1e-6


def _close(got, want, rel=1e-5, what=""):
    got, want = to_np(got), to_np(want)
    err, scale = np.abs(got - want).max(), np.abs(want).max()
    assert err <= rel * scale or err <= 1e-12, (what, err, scale)


def test_remat_train_step_matches_jax():
    params = j_load_config(TINY).to_dict()["tokenizer"]["params"]
    ttc = bench_train.remat_config(tokenizer_config_from_params(params), DEPTH)
    j0 = j_tok.tokenizer_config_from_params(params)
    jtc = dataclasses.replace(
        j0, encoder=dataclasses.replace(j0.encoder, gradient_checkpointing=True),
        decoder=dataclasses.replace(j0.decoder, depth=DEPTH, context_dim=64 * DEPTH,
                                    use_checkpoint=True))
    assert ttc.encoder.gradient_checkpointing and ttc.decoder.use_checkpoint
    tree = seeded_tree(lambda k: j_tok.tokenizer_init(k, jtc), 9,
                       {**encoder_tables(jtc.encoder, ("encoder",)),
                        **mmdit_tables(jtc.decoder, ("model",))})
    x = np.random.default_rng(0).standard_normal((B, 8, 8, 16)).astype(np.float32)
    key = jax.random.PRNGKey(4)

    # JAX: the train step, and the gradients it applies (the same loss, key
    # and VQ state through value_and_grad)
    j_tc = j_trainer.TrainConfig(dit_lr=1e-5, token_lr=5e-5)
    jstate, opt = j_trainer.make_train_state(jax_tree(tree), jtc, j_tc)
    _, j_logs = jax.jit(lambda s, b, r: j_trainer.train_step(s, opt, jtc, j_tc, b, r))(
        jstate, jnp.asarray(x), key)
    st = j_vq.vq_state_init(jstate.params["encoder"]["quantizer"], jtc.k)
    (j_loss, j_aux), j_grads = jax.jit(jax.value_and_grad(
        lambda p: j_tok.tokenizer_loss(p, jtc, jnp.asarray(x), key, vq_state=st),
        has_aux=True))(jstate.params)

    tok = convert.tokenizer_from_jax_tree(tree, ttc)
    tc = t_trainer.TrainConfig(dit_lr=1e-5, token_lr=5e-5)
    state = t_trainer.make_train_state(tok, ttc, tc)
    state, logs = t_trainer.train_step(state, ttc, tc, torch.from_numpy(x),
                                       **jax_step_draws(key, ttc, x.shape))

    _close(logs["loss"], j_logs["loss"], what="loss")
    _close(logs["loss"], j_loss, what="loss vs value_and_grad")
    for k in ("dm_mse", "quan_loss", "vq_n_reactive"):
        if k in j_logs:
            _close(logs[k], j_logs[k], what=k)
    np.testing.assert_array_equal(to_np(logs["ids"]), to_np(j_aux["ids"]))
    want = convert.tokenizer_state_dict(jax.tree_util.tree_map(np.asarray, j_grads), ttc)
    seen = 0
    for n, p in tok.named_parameters():
        if n == "encoder.quantizer._codebook.embed":      # moved by the EMA, not by gradients
            continue
        w = want[n].numpy()
        err, scale = np.abs(to_np(p.grad) - w).max(), np.abs(w).max()
        assert err <= GRAD_TOL * scale or err <= 1e-10, (n, err, scale)
        seen += 1
    assert seen == len(want) - 1


def test_measure_k1024_ids_match_jax():
    cfg = measure_k1024.k1024_config(TINY).to_dict()
    assert cfg["tokenizer"]["params"]["k"] == 1024
    jpipe, tpipe = pipeline_pair(cfg, steps=2, seed=21)
    assert tpipe.K == jpipe.tcfg.k == 1024
    images = np.random.default_rng(0).uniform(-1, 1, (2, 64, 64, 3)).astype(np.float32)
    ids = tpipe.encoding(torch.from_numpy(images)).numpy()
    j_ids = np.asarray(jpipe.encoding(images))
    assert ids.shape == j_ids.shape == (2, 1024)
    _, margins = tpipe.encoding_margins(torch.from_numpy(images))
    diff = ids != j_ids
    assert not np.any(diff & (margins.numpy() >= VQ_MARGIN)), int(diff.sum())
