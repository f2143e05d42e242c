"""The frozen arithmetic: FLOP counts against the program's own, the
decode's context buckets against a hand count, the kernel bounds against
the smoke test's, and the window and trace arithmetic on made-up numbers."""

from __future__ import annotations

import json
import os

import pytest
import torch

from benchmark.harness import spec, yardstick
from benchmark.harness.trace import Trace
from benchmark.harness.window import Window, gaps, percentile, union_length

CONFIGS = ["flagship-256", "flagship-renderer-256"]


def _config(name):
    with open(os.path.join(spec.HERE, "configs", name + ".json")) as f:
        return json.load(f)


def _tcfg(cfg):
    from selftoktokenizer_tpu_torch.models.tokenizer import tokenizer_config_from_params
    return tokenizer_config_from_params(cfg["tokenizer_params"])


@pytest.mark.parametrize("name", CONFIGS)
def test_flops_equal_the_program_s(name):
    from selftoktokenizer_tpu_torch.utils import flops
    cfg = _config(name)
    tcfg = _tcfg(cfg)
    res = cfg["image_size"]
    assert yardstick.vae_encoder_flops(res, cfg["vae"]) == flops.vae_encoder_flops(res)
    assert yardstick.vae_decoder_flops(res, cfg["vae"]) == flops.vae_decoder_flops(res)
    assert yardstick.encoder_flops(cfg["encoder"], res) == \
        flops.qformer_encoder_flops(tcfg.encoder, resolution=res)
    if not cfg["decoder"]["renderer"]:
        assert yardstick.mmdit_flops(cfg["decoder"], 256, cfg["K"]) == \
            flops.mmdit_step_flops(tcfg.decoder, n_x=256)


# the flagship's 50 steps by hand: t = 1000, 980, ..., 20 through the DiTi
# stages (0-200: 192 tokens, -400: 184, -600: 72, -800: 48, -1000: 16); a
# step's bucket is the 128-multiple above its last active token
HAND_BUCKETS = [512] * 29 + [384] * 8 + [256] * 7 + [128] * 6


def test_decode_counts_each_step_s_bucket():
    from benchmark.drivers.decode import Driver
    from selftoktokenizer_tpu_torch.utils import flops
    cfg = _config("flagship-256")
    drv = Driver.__new__(Driver)
    drv.cfg = cfg
    steps = drv._steps()
    assert [Lc for Lc, _ in steps] == HAND_BUCKETS
    mmdit, vae = yardstick.decode_flops(cfg, HAND_BUCKETS)
    tcfg = _tcfg(cfg)
    assert mmdit == sum(flops.mmdit_step_flops(tcfg.decoder, n_x=256, Lc=Lc) for Lc in HAND_BUCKETS)
    # the program's count takes the whole context at every step
    assert mmdit + vae < flops.decode50_flops(tcfg, 256)
    assert flops.decode50_flops(tcfg, 256) == 50 * flops.mmdit_step_flops(tcfg.decoder, n_x=256) + vae


def test_render_count_by_hand():
    cfg = _config("flagship-renderer-256")
    d = cfg["decoder"]
    D, L, n, K = 1536, 768, 256, 512
    per_block = 2 * L * D * 3 * D + 4 * (K * K + n * L) * D + 2 * L * D * D + 2 * 2 * L * D * 4 * D
    hand = 24 * per_block + 2 * K * 16 * D + 2 * n * D * 64
    assert yardstick.render_flops(cfg)[0] == hand
    assert d["renderer"]


def test_attention_bound_equals_the_smoke_test_s():
    import chip_smoke
    g = torch.Generator().manual_seed(0)
    B, H, L, D = 2, 24, 768, 64
    pos = torch.arange(L)[None, :]
    active = torch.randint(1, 512 + 1, (B,), generator=g)
    mask = (pos < active[:, None]) | (pos >= 512)
    for dtype, item in ((torch.bfloat16, 2), (torch.float32, 4)):
        ms, _, _ = chip_smoke.attn_bound(B, H, L, L, D, dtype, mask)
        ours = yardstick.attention_bound(B, H, L, L, D, item, chip_smoke.active_keys(mask, B, L))
        assert ours * 1e3 == pytest.approx(ms, rel=1e-12)


def test_vq_bound_equals_the_smoke_test_s(monkeypatch):
    import chip_smoke
    monkeypatch.setattr(chip_smoke, "sm_clock_hz", lambda: 1.98e9)
    ms, _, _ = chip_smoke.vq_bound(16384, 32768, 16)
    assert yardstick.vq_bound(16384, 32768, 16, 1.98e9) * 1e3 == pytest.approx(ms, rel=1e-12)


def test_peaks():
    assert yardstick.PEAKS == {"bf16": 989e12, "fp32": 165e12, "int8": 1979e12}
    assert yardstick.least_time({"bf16": 989e12, "fp32": 165e12}) == pytest.approx(2.0)


def test_window_arithmetic():
    assert percentile(list(range(1, 101)), 95) == 95
    assert percentile([3.0, 1.0, 2.0], 95) == 3.0
    assert percentile([5.0] * 20, 95) == 5.0
    iv = [(0.0, 1.0), (0.5, 2.0), (3.0, 4.0), (3.5, 3.6), (9.0, 12.0)]
    assert union_length(iv, 0.0, 10.0) == pytest.approx(4.0)
    assert union_length(iv, 1.5, 3.5) == pytest.approx(1.0)
    assert gaps(iv, 0.0, 10.0) == [(2.0, 3.0), (4.0, 9.0)]
    assert gaps([], 1.0, 2.0) == [(1.0, 2.0)]


def _reader(name):
    return spec.metric_reader(name)


def test_metric_readers_on_made_up_runs():
    class Run:
        pass

    run = Run()
    run.window = Window(calls=10, seconds=5.0, call_s=[0.5] * 9 + [0.6])
    run.images_per_call = 4
    run.setup_s = 12.5
    run.peak_bytes = 3 * 2 ** 30
    run.work = {"flops": {"bf16": 989e12 * 0.1}, "attention": [(1, 1, 64, 64, 64, 2, 64)],
                "steps": 5, "vq": (16, 64, 16)}
    run.traced_calls = 2
    run.sm_clock_hz = 1.98e9
    run.trace = Trace(lo=0.0, hi=1.0, host=[("cudaLaunchKernel", 0.0, 1.0)],
                      device=[("void flash_bf16_kernel<64>", 0.1, 0.2),
                              ("vq_argmax_kernel", 0.3, 0.35),
                              ("Memcpy HtoD", 0.5, 0.6),
                              ("gemm", 0.55, 0.7)])
    assert _reader("images_per_s")(run) == pytest.approx(8.0)
    assert _reader("batch_p95_ms")(run) == pytest.approx(600.0)
    assert _reader("setup_s")(run) == 12.5
    assert _reader("mfu.serve")(run) == pytest.approx(100 * 0.1 * 10 / 5.0)
    # busy 0.35 s of the traced window's 1.0 s, both from the trace
    assert _reader("device_idle_pct.serve")(run) == pytest.approx(100 * (1 - 0.35))
    assert _reader("peak_mem_gib.serve")(run) == pytest.approx(3.0)
    assert _reader("launches_per_call.decode")(run) == pytest.approx(3 / 2)
    bound = yardstick.attention_bound(1, 1, 64, 64, 64, 2, 64)
    assert _reader("attn_roofline.serve")(run) == pytest.approx(100 * 2 * bound / 0.1)
    vq = yardstick.vq_bound(16, 64, 16, 1.98e9)
    assert _reader("vq_roofline.serve")(run) == pytest.approx(100 * 2 * vq / 0.05)
    assert run.trace.top_ops(2)[0][0] == "gemm"
    assert run.trace.idle_gaps(1) == [["cudaLaunchKernel", pytest.approx(0.3)]]
    # a kernel renamed away: the roofline reads nothing, never 0
    run.trace.device = [("gemm", 0.1, 0.2)]
    assert _reader("attn_roofline.serve")(run) is None
    assert _reader("vq_roofline.serve")(run) is None
    # a device operation running past the window counts only inside it
    run.trace.device = [("gemm", 0.5, 1.7)]
    assert _reader("device_idle_pct.serve")(run) == pytest.approx(50.0)
    run.trace = None
    assert _reader("device_idle_pct.serve")(run) is None


def test_train_count_equals_the_program_s():
    from selftoktokenizer_tpu_torch.tools import bench_train
    cfg = _config("flagship-256")
    assert yardstick.train_flops(cfg, 4) == bench_train.train_flops(_tcfg(cfg), 4)


def test_backward_bound_equals_the_smoke_test_s():
    import chip_smoke
    B, H, L, D = 4, 24, 768, 64
    pos = torch.arange(L)[None, :]
    mask = (pos < torch.tensor([[100], [512], [3], [300]])) | (pos >= 512)
    ms, _, _ = chip_smoke.attn_backward_bound(B, H, L, L, D, torch.float32, mask)
    ours = yardstick.attention_backward_bound(B, H, L, L, D, 4, chip_smoke.active_keys(mask, B, L))
    assert ours * 1e3 == pytest.approx(ms, rel=1e-12)


def test_train_readers_on_a_made_up_run():
    class Run:
        pass

    run = Run()
    run.window = Window(calls=4, seconds=2.0, call_s=[0.5] * 4)
    run.traced_calls = 1
    case = (4, 24, 768, 768, 64, 4, 2000)
    run.work = {"flops": {"fp32": 165e12 * 0.25},
                "attention_by_call": {0: [("fwd",) + case], 7: [("fwd",) + case, ("bwd",) + case]}}
    run.trace = Trace(lo=0.0, hi=1.0, host=[], device=[("flash_tf32_fwd_kernel<64>", 0.1, 0.2),
                                                       ("flash_bwd_dq_kernel<64>", 0.2, 0.4)])
    assert _reader("train_step_s")(run) == pytest.approx(0.5)
    assert _reader("mfu.train")(run) == pytest.approx(100 * 0.25 * 4 / 2.0)
    bound = yardstick.attention_bound(*case[:-1], 2000) + yardstick.attention_backward_bound(*case)
    assert _reader("attn_roofline.train")(run) == pytest.approx(100 * bound / 0.3)
    assert _reader("device_idle_pct.train")(run) == pytest.approx(100 * (1 - 0.3 / 1.0))
