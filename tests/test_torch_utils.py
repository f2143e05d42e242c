"""The port's last utility modules: ``utils/guards.py`` (finite checks over
tensors and state dicts, the divergence guard's patience and ceiling),
``utils/profiling.py`` (a torch.profiler trace written on the CPU, the step
timer), ``utils/benchutil.py`` (time_fn / rate_fn) and ``utils/flops.py``,
every function of which equals the JAX package's on the flagship and the
tiny config."""

import math
import os

import pytest
import torch

from selftoktokenizer_tpu.core.config import load_config as j_load_config
from selftoktokenizer_tpu.models import tokenizer as j_tok
from selftoktokenizer_tpu.models.vae import VAEConfig as JVAEConfig
from selftoktokenizer_tpu.utils import flops as j_flops
from selftoktokenizer_tpu_torch.core.config import FLAGSHIP_CONFIG
from selftoktokenizer_tpu_torch.models import tokenizer as t_tok
from selftoktokenizer_tpu_torch.models.vae import VAEConfig
from selftoktokenizer_tpu_torch.utils import benchutil, flops, guards, profiling
from tests.torch_port_helpers import TINY


def test_tree_finite_over_tensors_and_state_dicts():
    assert bool(guards.tree_finite(torch.ones(3)))
    assert not bool(guards.tree_finite(torch.tensor([1.0, float("nan")])))
    sd = torch.nn.Linear(4, 3).state_dict()
    assert bool(guards.tree_finite(sd))
    sd["bias"][1] = float("inf")
    assert not bool(guards.tree_finite(sd))
    nested = {"a": [torch.zeros(2), (torch.ones(1),)], "step": 3,
              "ids": torch.tensor([1, 2]), "flag": torch.tensor(True)}
    assert bool(guards.tree_finite(nested))
    nested["a"][1] = (torch.tensor([-float("inf")]),)
    assert not bool(guards.tree_finite(nested))
    assert bool(guards.tree_finite({"n": 1}))              # nothing to check
    assert guards.tree_finite(torch.ones(2)).ndim == 0


def test_divergence_guard_patience_and_ceiling():
    g = guards.DivergenceGuard(patience=3, loss_ceiling=10.0)
    assert g.check(1.0, "s1") and g.last_good == "s1"
    assert not g.check(float("nan"), "bad") and g.bad_streak == 1
    assert not g.check(11.0, "bad") and g.bad_streak == 2      # above the ceiling
    assert g.check(2.0, "s2") and g.bad_streak == 0 and g.last_good == "s2"
    g.check(math.inf)
    g.check(float("nan"))
    with pytest.raises(FloatingPointError, match="3 consecutive steps"):
        g.check(100.0)
    assert g.last_good == "s2"
    with pytest.raises(FloatingPointError):
        guards.DivergenceGuard().check(float("nan"))           # patience 1
    assert guards.DivergenceGuard(loss_ceiling=None).check(1e30)


def test_trace_writes_a_file_on_the_cpu(tmp_path):
    d = tmp_path / "trace"
    with profiling.trace(str(d)) as prof:
        with profiling.annotate("matmul_region"):
            torch.randn(16, 16) @ torch.randn(16, 16)
    files = os.listdir(d)
    assert len(files) == 1 and files[0].endswith(".json")
    text = (d / files[0]).read_text()
    assert "matmul_region" in text
    assert any("matmul_region" in e.key for e in prof.key_averages())


def test_timers_return_positive_numbers():
    a = torch.randn(32, 32)
    assert profiling.step_timer(lambda x: (x @ x, {"k": [x]}), a, iters=3, warmup=1) > 0
    assert benchutil.time_fn(lambda x: x @ x, a, iters=3, warm=0) > 0
    assert benchutil.rate_fn(lambda x: x @ x, a, iters=3) > 0
    benchutil.sync()


@pytest.mark.parametrize("cfg_path", [FLAGSHIP_CONFIG, TINY])
def test_flops_equal_the_jax_package(cfg_path):
    params = j_load_config(cfg_path).to_dict()["tokenizer"]["params"]
    jtc = j_tok.tokenizer_config_from_params(params)
    ttc = t_tok.tokenizer_config_from_params(params)
    res = ttc.image_size
    pairs = [
        (flops.vae_encoder_flops(res), j_flops.vae_encoder_flops(res)),
        (flops.vae_decoder_flops(res), j_flops.vae_decoder_flops(res)),
        (flops.vae_encoder_flops(512, VAEConfig(ch=64)),
         j_flops.vae_encoder_flops(512, JVAEConfig(ch=64))),
        (flops.vae_decoder_flops(512, VAEConfig(ch=64)),
         j_flops.vae_decoder_flops(512, JVAEConfig(ch=64))),
        (flops.qformer_encoder_flops(ttc.encoder), j_flops.qformer_encoder_flops(jtc.encoder)),
        (flops.qformer_encoder_flops(ttc.encoder, resolution=2 * res),
         j_flops.qformer_encoder_flops(jtc.encoder, resolution=2 * res)),
        (flops.qformer_encoder_mxu_slots(ttc.encoder),
         j_flops.qformer_encoder_mxu_slots(jtc.encoder)),
        (flops.qformer_encoder_mxu_slots(ttc.encoder, resolution=2 * res),
         j_flops.qformer_encoder_mxu_slots(jtc.encoder, resolution=2 * res)),
        (flops.mmdit_step_flops(ttc.decoder), j_flops.mmdit_step_flops(jtc.decoder)),
        (flops.mmdit_step_flops(ttc.decoder, n_x=64, Lc=0),
         j_flops.mmdit_step_flops(jtc.decoder, n_x=64, Lc=0)),
        (flops.encode_flops(ttc, res), j_flops.encode_flops(jtc, res)),
    ]
    for cfg_scale in (1.0, 2.0):
        pairs.append((flops.decode50_flops(ttc, res, cfg_scale=cfg_scale),
                      j_flops.decode50_flops(jtc, res, cfg_scale=cfg_scale)))
        pairs.append((flops.decode50_flops(ttc, res, steps=8, cfg_scale=cfg_scale),
                      j_flops.decode50_flops(jtc, res, steps=8, cfg_scale=cfg_scale)))
    for i, (got, want) in enumerate(pairs):
        assert got == want and (got > 0 if not isinstance(got, tuple) else min(got) > 0), (i, got,
                                                                                        want)


def test_flops_with_register_tokens_count_a_second_forward():
    params = j_load_config(TINY).to_dict()["tokenizer"]["params"]
    jtc = j_tok.tokenizer_config_from_params(params)
    ttc = t_tok.tokenizer_config_from_params(params)
    jtc.decoder.register_length = ttc.decoder.register_length = 4
    for cfg_scale in (1.0, 3.0):
        assert flops.decode50_flops(ttc, 64, cfg_scale=cfg_scale) == \
            j_flops.decode50_flops(jtc, 64, cfg_scale=cfg_scale)
    assert flops.decode50_flops(ttc, 64, cfg_scale=3.0) > flops.decode50_flops(ttc, 64)
