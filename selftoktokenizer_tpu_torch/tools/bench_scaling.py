"""Data-parallel encode over ranks: images a second a rank and the
efficiency against one rank (counterpart of the reference
``tools/bench_scaling.py``).

    torchrun --standalone --nproc_per_node N \\
        -m selftoktokenizer_tpu_torch.tools.bench_scaling [--batch-per-chip 16] \\
        [--sizes 1,2,4] [--iters 5] [--tiny YML] [--device cuda]

One process a card, as ``torchrun`` starts them: the group forms through
``parallel/distributed.py::init`` (NCCL on the card, gloo with ``--device
cpu``; ``--init-method`` takes an explicit address such as
``tcp://localhost:PORT`` or ``file://PATH``, the rank and world size then
read from ``RANK`` / ``WORLD_SIZE`` or 0 / 1), and the mesh is
``parallel/mesh.py::make_mesh(data=N)`` over every rank. Without a
launcher and without ``--init-method`` it runs one process, N = 1.

The flagship config (``configs/flagship-256.yml``) at 256 px, or with
``--tiny YML`` that config at 64 px; seeded weights (non-zero adaLN, the
same on every rank), an encode-only pipeline at 'highest'. For each size n
of ``--sizes`` (default: 1 and the world size): a global batch of
n x ``--batch-per-chip`` images from numpy's ``default_rng(0)``, uniform
in [-1, 1]; ranks 0..n-1 each encode their rows ``--iters`` times after
one warm encode, between two barriers of the whole group; the rate is the
global images over the wall between the barriers. Reports for each n the
images a second, those a rank and the efficiency against the first size,
with the reference's keys, and the card's name and power limit. At the
world size the ranks' ids are gathered over the mesh's data group, in
rank order (returned by ``main``, not printed).
"""

from __future__ import annotations

import argparse
import os
import time

import torch
import torch.distributed as dist

from selftoktokenizer_tpu_torch.core.config import FLAGSHIP_CONFIG
from selftoktokenizer_tpu_torch.parallel import distributed as pdist
from selftoktokenizer_tpu_torch.tools import common


def measure(pipe, n, batch_per_chip, iters, size, device):
    """(images a second over the n encoding ranks, this rank's ids or None)."""
    from selftoktokenizer_tpu_torch.utils.benchutil import sync

    rank, _ = pdist.rank_and_world()
    images = common.uniform_images(n * batch_per_chip, size, "cpu")
    mine = images[rank * batch_per_chip:(rank + 1) * batch_per_chip].to(device) \
        if rank < n else None
    ids = None
    if mine is not None:
        ids = pipe.encoding(mine)                  # warm
    sync()
    barrier()
    t0 = time.perf_counter()
    if mine is not None:
        for _ in range(iters):
            ids = pipe.encoding(mine)
    sync()
    barrier()
    return n * batch_per_chip * iters / (time.perf_counter() - t0), ids


def barrier():
    if dist.is_initialized():
        dist.barrier()


def build_parser():
    p = argparse.ArgumentParser("bench_scaling")
    p.add_argument("--batch-per-chip", type=int, default=16)
    p.add_argument("--sizes", type=str, default="")
    p.add_argument("--tiny", default=None, metavar="YML",
                   help="a small config (e.g. tests/data/tiny-eval.yml), encoded at 64 px")
    p.add_argument("--iters", type=int, default=5)
    p.add_argument("--init-method", default=None,
                   help="the group's address (tcp://localhost:PORT, file://PATH) when "
                        "no launcher set one")
    p.add_argument("--device", default="cuda", help="'cpu' to run gloo ranks on the CPU")
    return p


def main(argv=None):
    """Run the tool; returns the dict of its JSON line, and under "ids" the
    gathered ids at the world size (on every rank)."""
    from selftoktokenizer_tpu_torch.parallel.mesh import make_mesh

    args = build_parser().parse_args(argv)
    device = common.resolve_device(args.device)
    formed_here = not dist.is_initialized()
    kw = {}
    if args.init_method:
        kw = {"init_method": args.init_method, "rank": int(os.environ.get("RANK", 0)),
              "world_size": int(os.environ.get("WORLD_SIZE", 1))}
    grouped = pdist.init(backend="gloo" if device.type == "cpu" else None, **kw)
    try:
        rank, world = pdist.rank_and_world()
        if device.type == "cuda":
            device = torch.device("cuda", torch.cuda.current_device())
        mesh = make_mesh(data=world) if grouped else None
        yml, size = (args.tiny, 64) if args.tiny else (FLAGSHIP_CONFIG, 256)
        pipe = common.seeded_pipeline(yml, device, datasize=size, encode_only=True)
        sizes = [int(s) for s in args.sizes.split(",") if s] or sorted({1, world})
        results, base, gathered = {}, None, None
        for n in sizes:
            if n > world:
                continue
            rate, ids = measure(pipe, n, args.batch_per_chip, args.iters, size, device)
            per_chip = rate / n
            base = per_chip if base is None else base
            results[str(n)] = {"images_per_s": rate, "per_chip": per_chip,
                               "efficiency": per_chip / base}
            if rank == 0:
                print(f'{{"chips": {n}, "images_per_s": {rate}, "per_chip": {per_chip}, '
                      f'"efficiency": {per_chip / base}}}', flush=True)
            if n == world:
                group = mesh.get_group("data") if mesh is not None else None
                gathered = pdist.all_gather_rows(ids.to(pdist.comm_device(group)), group).cpu()
        line = {"metric": "dp_scaling", "results": results, "world": world,
                "batch_per_chip": args.batch_per_chip, "data_size": size,
                "backend": dist.get_backend() if grouped else None,
                "card": common.card_line(device)}
        if rank == 0:
            common.emit(line)
        return {**line, "ids": gathered}
    finally:
        if formed_here and dist.is_initialized():
            dist.destroy_process_group()


if __name__ == "__main__":
    main()
