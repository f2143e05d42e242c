"""What the tools share: the choice of image loader, batches of images
with the name of each row, and the device-side copy.

Loaders: ``'native'`` is the C++ loader (``data/native.py``), chosen where
it can be built here (``native_available``: a C++ compiler with the libjpeg
and libpng headers); ``'pil'`` is ``pipeline/preprocess.py``. Both give
float32 NHWC in [-1, 1]; they agree within 3 uint8 levels.
"""

from __future__ import annotations

import io

import numpy as np

from selftoktokenizer_tpu_torch.data import native
from selftoktokenizer_tpu_torch.parallel.distributed import rank_and_world
from selftoktokenizer_tpu_torch.pipeline.preprocess import load_image, preprocess_pil

IMAGE_EXT = (".jpg", ".jpeg", ".png")
N_THREADS = 4          # the C++ loader's decode threads


def choose_loader():
    """'native' where the C++ loader can be built here, else 'pil'."""
    return "native" if native.native_available() else "pil"


def load_fn(loader):
    """(path, size) -> [1, size, size, 3] of the loader."""
    return native.preprocess_file if loader == "native" else load_image


def pil_bytes(data, size):
    """Encoded image bytes -> [1, size, size, 3] through PIL; raises
    OSError when they do not decode (PIL also raises SyntaxError and
    ValueError for some broken files)."""
    from PIL import Image

    try:
        return preprocess_pil(Image.open(io.BytesIO(data)), size)
    except (SyntaxError, ValueError) as e:
        raise OSError(f"PIL cannot decode the member: {e}") from e


def file_batches(paths, size, batch, loader):
    """(images [n, size, size, 3], names [n]) batches over ``paths``. The
    native loader returns them in its workers' order, so each row's path
    travels with it; PIL goes in path order."""
    if loader == "native":
        with native.NativeImageLoader(paths, size=size, batch=batch,
                                      n_threads=N_THREADS) as ld:
            while True:
                try:
                    imgs, idx = ld.next_with_indices()
                except StopIteration:
                    return
                yield imgs, np.asarray([paths[i] for i in idx])
    else:
        for i in range(0, len(paths), batch):
            chunk = paths[i:i + batch]
            yield np.concatenate([load_image(q, size) for q in chunk]), np.asarray(chunk)


def shard_batches(shards, size, batch, loader, limit=0):
    """(images, keys) batches over tar shards (``TarShardLoader``; members
    decode through the chosen loader), at most ``limit`` rows when it is
    not 0."""
    seen = 0
    decode = None if loader == "native" else pil_bytes
    for imgs, keys in native.TarShardLoader(shards, size=size, batch=batch, decode=decode):
        if limit and seen + imgs.shape[0] >= limit:
            take = limit - seen
            if take > 0:
                yield imgs[:take], np.asarray(keys[:take])
            return
        seen += imgs.shape[0]
        yield imgs, np.asarray(keys)


def rank_share(n):
    """This rank's share of a global count n: n // world, plus one for the
    first n % world ranks."""
    r, w = rank_and_world()
    return n // w + (1 if r < n % w else 0)
