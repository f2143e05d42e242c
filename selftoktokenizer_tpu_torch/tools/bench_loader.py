"""Host-side image loader rates on a synthetic JPEG corpus (counterpart of
the reference ``tools/bench_loader.py``).

    python -m selftoktokenizer_tpu_torch.tools.bench_loader [--n 512] \\
        [--size 256] [--batch 32] [--threads 4]

Writes ``--n`` random 320 x 320 JPEGs (PIL, quality 90, from numpy's
``default_rng(0)``) and one tar shard of them into a temporary directory,
so the rates are decode + resize + crop + normalise work, not disk. Rows,
in images a second:

* ``native_loader``: the C++ loader (``data/native.py`` over
  ``csrc/dataloader.cc``), its threaded ring, the second of two epochs
  (the first warms the allocator);
* ``native_single``: the C++ decode one call an image (128 images);
* ``pil``: ``pipeline/preprocess.py::load_image`` (128 images);
* ``tar_loader``: ``TarShardLoader`` over the shard, its members decoded by
  the C++ loader where it builds here, else by PIL (``tar_decoder`` says
  which).

The C++ loader needs a compiler that finds ``jpeglib.h`` and ``png.h``;
where it cannot build, its two rows are ``null`` and
``native_unavailable_reason`` gives the reason (PIL is never timed under
a native row's name). One JSON line.
"""

from __future__ import annotations

import argparse
import os
import tarfile
import tempfile
import time

import numpy as np

from selftoktokenizer_tpu_torch.tools import common

SINGLE = 128          # images of the one-call-an-image rows


def make_corpus(root, n, px=320):
    """n random JPEGs and one tar shard holding them: (paths, [shard])."""
    from PIL import Image

    rng = np.random.default_rng(0)
    os.makedirs(os.path.join(root, "imgs"))
    paths = []
    for i in range(n):
        p = os.path.join(root, "imgs", f"{i:05d}.jpg")
        Image.fromarray(rng.integers(0, 255, (px, px, 3), dtype=np.uint8)).save(p, quality=90)
        paths.append(p)
    tar_path = os.path.join(root, "shard-000.tar")
    with tarfile.open(tar_path, "w") as tf:
        for p in paths:
            tf.add(p, arcname=os.path.basename(p))
    return paths, [tar_path]


def build_parser():
    p = argparse.ArgumentParser("bench_loader")
    p.add_argument("--n", type=int, default=512)
    p.add_argument("--size", type=int, default=256)
    p.add_argument("--batch", type=int, default=32)
    p.add_argument("--threads", type=int, default=4)
    return p


def main(argv=None):
    """Run the tool; returns the dict of its JSON line."""
    from selftoktokenizer_tpu_torch.data import native
    from selftoktokenizer_tpu_torch.pipeline.preprocess import load_image

    args = build_parser().parse_args(argv)
    reason = native.unavailable_reason()
    out = {"n": args.n, "size": args.size, "batch": args.batch, "threads": args.threads,
           "native_available": reason is None, "native_unavailable_reason": reason,
           "native_loader_img_per_s": None, "native_single_img_per_s": None}
    single = min(SINGLE, args.n)
    with tempfile.TemporaryDirectory() as root:
        paths, shards = make_corpus(root, args.n)
        if reason is None:
            def epoch():
                seen = 0
                with native.NativeImageLoader(paths, size=args.size, batch=args.batch,
                                              n_threads=args.threads) as loader:
                    t0 = time.perf_counter()
                    while True:
                        try:
                            imgs, _ = loader.next_with_indices()
                        except StopIteration:
                            break
                        seen += imgs.shape[0]
                    return seen, time.perf_counter() - t0

            epoch()
            seen, dt = epoch()
            out["native_loader_img_per_s"] = seen / dt
            out["native_loader_decoded"] = seen
            t0 = time.perf_counter()
            for p in paths[:single]:
                native.preprocess_file(p, args.size)
            out["native_single_img_per_s"] = single / (time.perf_counter() - t0)

        t0 = time.perf_counter()
        for p in paths[:single]:
            load_image(p, args.size)
        out["pil_img_per_s"] = single / (time.perf_counter() - t0)

        decode = None if reason is None else common.pil_bytes
        t0 = time.perf_counter()
        seen = 0
        for imgs, _ in native.TarShardLoader(shards, size=args.size, batch=args.batch,
                                             decode=decode):
            seen += imgs.shape[0]
        out["tar_loader_img_per_s"] = seen / (time.perf_counter() - t0)
        out["tar_decoder"] = "native" if reason is None else "pil"
        out["tar_decoded"] = seen
    return common.emit(out)


if __name__ == "__main__":
    main()
