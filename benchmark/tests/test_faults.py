"""A run with the timed path broken underneath reads ``correct`` false: each
cell's own driver, options and limits at the tiny configuration on the CPU
(the look for a card skipped), once for each fault the cell can have. Every
cell runs on one chip and exchanges nothing, so no fault of an exchange
applies."""

from __future__ import annotations

import time

import pytest
import torch

from benchmark.run import run_cell
from benchmark.tests.faults import train_faults
from benchmark.tests.helpers import real_cell, tiny_config

DECODE = "flagship-256.decode-bf16-b32"
RENDER = "flagship-renderer-256.render-bf16-b32"
ENCODE = "flagship-256.encode-highest-b32"
TRAIN = "flagship-256.train-fp32-b4"
TRAFFIC = {DECODE: {"inputs": "ids", "batch": 2, "pool": 2, "noise": True},
           RENDER: {"inputs": "ids", "batch": 2, "pool": 2},
           ENCODE: {"inputs": "images", "batch": 2, "pool": 2},
           TRAIN: {"inputs": "latents", "batch": 4}}
SEED = 3_000_000_017


def _tiny(workload):
    cell = real_cell(workload)
    cell.config = tiny_config(renderer=workload == RENDER)
    cell.traffic = TRAFFIC[workload]
    return cell


def _run(workload, patch=None):
    cell = _tiny(workload)
    result, _ = run_cell(cell, SEED, 0.0, device="cpu", t0=time.perf_counter(), patch=patch,
                         calls=cell.traffic.get("pool", 1))
    return result


def _wrap(fn):
    def patch(drv):
        orig = drv._call
        drv._call = lambda batch: fn(orig, batch)
    return patch


def _alter(out):
    if isinstance(out, tuple):                    # (images, latents)
        images, latents = out
        latents = latents.clone()
        latents[0, 0, 0, 0] += 1.0
        return images, latents
    ids = out.clone()
    ids[0, 0] = (ids[0, 0] + 1) % 64
    return ids


def _half(orig, batch):
    """The program answers the first half of the batch; the rest takes the
    mean of those answers."""
    n = next(iter(batch.values())).shape[0] // 2
    out = orig({k: v[:n] for k, v in batch.items()})

    def fill(t):
        m = t.float().mean(dim=0, keepdim=True)
        m = m.round().to(t.dtype) if not t.is_floating_point() else m.to(t.dtype)
        return torch.cat([t, m.expand(t.shape[0], *t.shape[1:])])
    return tuple(fill(t) for t in out) if isinstance(out, tuple) else fill(out)


@pytest.mark.parametrize("fault", ["unchanged", "half", "altered"])
def test_a_faulty_train_step_is_caught(fault):
    assert _run(TRAIN, train_faults()[fault])["correct"] is False


def _unchanged_step(monkeypatch):
    from selftoktokenizer_tpu_torch.models import flow
    monkeypatch.setattr(flow, "euler_step", lambda x, v, a, b, p="velocity": (x, x))


@pytest.mark.parametrize("workload", [DECODE, RENDER, ENCODE, TRAIN])
def test_sound_run_is_correct(workload):
    assert _run(workload)["correct"] is True


@pytest.mark.parametrize("workload", [DECODE, RENDER, ENCODE])
def test_an_altered_answer_is_caught(workload):
    assert _run(workload, _wrap(lambda orig, b: _alter(orig(b))))["correct"] is False


@pytest.mark.parametrize("workload", [DECODE, RENDER, ENCODE])
def test_half_the_batch_left_out_is_caught(workload):
    assert _run(workload, _wrap(_half))["correct"] is False


def test_a_step_that_leaves_the_state_unchanged_is_caught(monkeypatch):
    _unchanged_step(monkeypatch)
    assert _run(DECODE)["correct"] is False
