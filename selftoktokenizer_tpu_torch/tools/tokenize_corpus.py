"""Tokenize an image corpus: a folder of images, or of webdataset-style
``.tar`` shards, -> one ``.npz`` of ids (counterpart of the reference
``tools/tokenize_corpus.py``).

    python -m selftoktokenizer_tpu_torch.tools.tokenize_corpus \\
        --data-dir imgs/ --out tokens.npz [--pretrained tok.pth --vae-path sd3.pt] \\
        [--batch-size 64] [--limit N] [--encode-precision highest|high|default] \\
        [--margin-stats] [--device cuda]

The file holds ``tokens`` [N, K] int32, ``paths`` [N] (each row's source:
the image path, or ``shard/member`` of a shard) and, with
``--margin-stats``, ``margins`` [N, K] (the VQ top-2 margins of the encode
path in use). One process per card under ``torchrun --nproc_per_node N``:
each rank takes its ``process_slice`` of the sorted image list (of the
shard list for shards; ``--limit`` is global and split over the ranks) and
writes ``<out>.part<rank>.npz``, which ``tools/merge_token_parts.py``
merges. The image loader is the C++ one where it can be built
here, else PIL (``tools/common.py``); the JSON line says which ran.
"""

from __future__ import annotations

import argparse
import json
import time

import numpy as np
import torch

from selftoktokenizer_tpu_torch.core.config import FLAGSHIP_CONFIG, load_config
from selftoktokenizer_tpu_torch.data.native import to_device
from selftoktokenizer_tpu_torch.parallel import distributed as pdist
from selftoktokenizer_tpu_torch.tools import common
from selftoktokenizer_tpu_torch.utils.io import walk_all_files


def build_parser():
    p = argparse.ArgumentParser("tokenize_corpus")
    p.add_argument("--yml-path", default=FLAGSHIP_CONFIG)
    p.add_argument("--pretrained", default=None, help="tokenizer .pth (encoder read)")
    p.add_argument("--vae-path", default=None, help="SD3 VAE .pt")
    p.add_argument("--data-dir", required=True)
    p.add_argument("--out", default="tokens.npz")
    p.add_argument("--data_size", type=int, default=256)
    p.add_argument("--batch-size", type=int, default=64)
    p.add_argument("--limit", type=int, default=0,
                   help="at most this many images in all (0: every image)")
    p.add_argument("--encode-precision", default="highest",
                   choices=("highest", "high", "default"),
                   help="'highest': exact fp32; 'high': TF32 inside the call; "
                        "'default': the bf16 serving trunk (certify with --margin-stats)")
    p.add_argument("--margin-stats", action="store_true",
                   help="also store each token's VQ top-2 margin and print their quantiles")
    p.add_argument("--device", default="cuda", help="'cpu' to run on the CPU")
    return p


def tokenize(pipe, batches, margin_stats=False):
    """Encode every (images, names) batch. Returns a dict: tokens [N, K]
    int32, paths [N], margins [N, K] float32 or None, n, wall_s (the loop,
    loading included), encode_s (the host clock around each encode, ending
    in its result's copy to the host) and device_s (CUDA events around each
    encode on a CUDA device, else None)."""
    cuda = pipe.device.type == "cuda"
    toks, names_all, margins = [], [], []
    events = []
    encode_s = 0.0
    t0 = time.perf_counter()
    for imgs, names in batches:
        if imgs.shape[0] == 0:
            continue
        x = to_device(imgs, pipe.device)
        t = time.perf_counter()
        if cuda:
            ev = (torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True))
            ev[0].record()
        if margin_stats:
            ids, marg = pipe.encoding_margins(x)
            margins.append(marg.float().cpu().numpy())
        else:
            ids = pipe.encoding(x)
        if cuda:
            ev[1].record()
            events.append(ev)
        toks.append(ids.cpu().numpy().astype(np.int32))
        encode_s += time.perf_counter() - t
        names_all.append(np.asarray(names))
    if cuda:
        torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    return {"tokens": np.concatenate(toks) if toks else np.zeros((0, pipe.K), np.int32),
            "paths": np.concatenate(names_all) if names_all else np.zeros((0,), dtype="U1"),
            "margins": np.concatenate(margins) if margins else None,
            "n": int(sum(t.shape[0] for t in toks)), "wall_s": wall, "encode_s": encode_s,
            "device_s": sum(a.elapsed_time(b) for a, b in events) / 1e3 if cuda else None}


def margin_summary(margins):
    """Quantiles of the margins and the counts below 1e-2 and 1e-4 (the
    tokens whose id bf16-sized noise could flip)."""
    q = np.quantile(margins, [0.0, 0.001, 0.01, 0.05, 0.5])
    return {"min": float(q[0]), "p0.1": float(q[1]), "p1": float(q[2]),
            "p5": float(q[3]), "median": float(q[4]),
            "below_1e-2": int(np.sum(margins < 1e-2)),
            "below_1e-4": int(np.sum(margins < 1e-4)),
            "total_tokens": int(margins.size)}


def main(argv=None):
    """Run the tool; returns the dict of its JSON line."""
    from selftoktokenizer_tpu_torch.pipeline import SelftokPipeline

    args = build_parser().parse_args(argv)
    device = torch.device(args.device)
    pdist.init(backend="gloo" if device.type == "cpu" else None)
    rank, world = pdist.rank_and_world()
    # an encode-only pipeline: the decoder is never built
    pipe = SelftokPipeline(load_config(args.yml_path), ckpt_path=args.pretrained,
                           vae_path=args.vae_path, datasize=args.data_size,
                           encode_only=True, encode_precision=args.encode_precision,
                           device=device)

    loader = common.choose_loader()
    shards = walk_all_files(args.data_dir, (".tar",))
    paths = walk_all_files(args.data_dir, common.IMAGE_EXT)
    if shards and not paths:
        # the shard list is split over the ranks; a rank with no shard (more
        # ranks than shards) writes an empty part, so part numbers stay dense
        lo, hi = pdist.process_slice(len(shards))
        shards = shards[lo:hi]
        limit = common.rank_share(args.limit) if args.limit else 0
        if args.limit and limit == 0:
            shards = []
        batches = common.shard_batches(shards, args.data_size, args.batch_size, loader, limit)
    else:
        if args.limit:
            paths = paths[:args.limit]
        lo, hi = pdist.process_slice(len(paths))
        paths = paths[lo:hi]
        if not paths:
            raise SystemExit(f"no images or .tar shards under {args.data_dir}")
        batches = common.file_batches(paths, args.data_size, args.batch_size, loader)

    res = tokenize(pipe, batches, margin_stats=args.margin_stats)
    if res["n"] == 0 and shards:
        raise SystemExit(f"{len(shards)} .tar shard(s) yielded no decodable images "
                         f"under {args.data_dir}")
    out_name = args.out
    if world > 1:
        base = args.out[:-4] if args.out.endswith(".npz") else args.out
        out_name = f"{base}.part{rank}.npz"
    elif not out_name.endswith(".npz"):
        out_name += ".npz"           # the name numpy writes
    extra, summary = {}, {}
    if res["margins"] is not None:
        extra["margins"] = res["margins"].astype(np.float32)
        summary["margin_stats"] = margin_summary(res["margins"])
    np.savez_compressed(out_name, tokens=res["tokens"], paths=res["paths"], **extra)
    line = {"n": res["n"], "images_per_s": res["n"] / res["wall_s"],
            "encode_images_per_s": res["n"] / res["encode_s"] if res["encode_s"] else None,
            "device_busy_share": (res["device_s"] / res["wall_s"]
                                  if res["device_s"] is not None else None),
            "loader": loader, "encode_precision": pipe.encode_precision,
            "out": out_name, "device": str(pipe.device), **summary}
    print(json.dumps(line), flush=True)
    return line


if __name__ == "__main__":
    main()
