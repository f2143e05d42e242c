"""The one generator of every traffic mix: a pool of batches, made on the
device from ``--seed`` by the parameters of ``traffic/<name>.json``.

Parameters:

* ``inputs``: ``ids`` (token rows drawn uniformly from the codebook) or
  ``images`` (NHWC images uniform in [-1, 1] at the configuration's size);
* ``batch``: rows a call;
* ``pool``: batches made; call ``i`` takes batch ``i % pool``;
* ``noise``: with ``ids``, a start noise [batch, size/8, size/8, 16] a
  batch, normal.

``inputs`` ``latents`` is a training feed: no pool; step ``s`` takes fresh
rows [batch, size/8, size/8, 16], normal, from (seed, step) (``latents``).

Every seed gives the same sizes; only the values change.
"""

from __future__ import annotations

import torch


def _gen(seed, device):
    g = torch.Generator(device=device)
    g.manual_seed((int(seed) * 4 + 0) % (2 ** 63 - 1))   # part 0: the traffic
    return g


def latents(traffic, cfg, seed, step, device):
    """The training rows of step ``step``: NHWC normals [batch, h, w, 16]."""
    g = torch.Generator(device=device)
    g.manual_seed((int(seed) * 1_000_003 + int(step)) * 4 % (2 ** 63 - 1))
    lat = cfg["image_size"] // 8
    return torch.randn((traffic["batch"], lat, lat, cfg["vae"]["z_channels"]), generator=g,
                       device=device)


def make(traffic, cfg, seed, device):
    """[{name: tensor}] of ``traffic["pool"]`` batches."""
    g = _gen(seed, device)
    B, size = traffic["batch"], cfg["image_size"]
    pool = []
    for _ in range(traffic["pool"]):
        if traffic["inputs"] == "ids":
            batch = {"ids": torch.randint(0, cfg["codebook_size"], (B, cfg["K"]), generator=g,
                                          device=device)}
            if traffic.get("noise"):
                lat = size // 8
                batch["noise"] = torch.randn((B, lat, lat, cfg["vae"]["z_channels"]),
                                             generator=g, device=device)
        elif traffic["inputs"] == "images":
            batch = {"images": torch.rand((B, size, size, 3), generator=g, device=device)
                     * 2.0 - 1.0}
        else:
            raise ValueError(f"unknown inputs {traffic['inputs']!r}")
        pool.append(batch)
    return pool
