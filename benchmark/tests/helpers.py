"""Shared pieces of the benchmark's tests: the tiny configurations, cells
built from them, and a skip for tests that need a CUDA device."""

from __future__ import annotations

import json
import os

import pytest
import torch

from benchmark.harness import spec

DATA = os.path.join(os.path.dirname(os.path.abspath(__file__)), "data")


def tiny_config(renderer=False):
    with open(os.path.join(DATA, "tiny-renderer.json" if renderer else "tiny.json")) as f:
        return json.load(f)


def tiny_cell(driver, options, traffic, renderer=False, name=None):
    """A spec.Cell of the tiny configuration with the given driver options,
    the traffic parameters and placeholder limits (1.0)."""
    limits = {"decode": {"latent_rms_rel": 1.0, "vae_image_rel": 1.0},
              "render": {"latent_pooled_rel": 1.0, "vae_image_rel": 1.0},
              "encode": {"id_mismatch_share": 1.0},
              "train": {"loss_rel_gap": 1.0, "grad_norm_gap": 1.0, "change_norm_gap": 1.0}}[driver]
    return spec.Cell(name=name or f"tiny.{driver}", chips=1, config=tiny_config(renderer),
                     traffic=dict(traffic),
                     options={"driver": driver, "driver_options": dict(options),
                              "trace_calls": 2, "limits": limits},
                     end_to_end=[], per_layer=[])


def real_cell(workload):
    """A cell of BENCHMARK.json, with its own files."""
    return spec.load_cell(workload)


def need_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
