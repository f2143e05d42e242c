"""The training drivers' data streams (the generators of the reference
``tools/train_tokenizer.py``, each a function of its own here).

Every stream is an endless generator of batches that takes ``skip=N``: a
resumed run realigns the deterministic stream with the uninterrupted one
by dropping the first N batches without encoding them. Streams that go
through the corpus in passes bump ``passes.n`` at the end of each pass, and
``with_epoch_flags`` turns that into a flag on the batch that ends an epoch.

* ``latents_stream``: a latents ``.npy`` (``gen_corpus --latents-out``,
  ``encode_corpus``), memory-mapped; the rows past ``n_train`` are the
  held-out eval rows; with a data seed each pass permutes the rows by
  ``default_rng((data_seed, pass))``, and a batch gathers its rows sorted.
* ``synthetic_stream``: standard-normal latents from ``default_rng(0)``.
* ``folder_stream``: an image folder, in path order through the chosen
  loader (``common.file_batches``); full batches only.
* ``tar_stream``: ``.tar`` shards: each epoch the global shard list is
  shuffled by (data seed, epoch) and this rank takes its
  ``process_slice``; the sample shuffle buffer; the resume skip either
  drops raw members before decoding (``skip_samples``; exact when every
  member decodes) or, with ``exact``, drains decoded batches.

Image streams yield ``encode(images)``: the latents, made on the device
(``common.encode_to_latents``), which stay there.
"""

from __future__ import annotations

import numpy as np

from selftoktokenizer_tpu_torch.data import native
from selftoktokenizer_tpu_torch.parallel.distributed import process_slice
from selftoktokenizer_tpu_torch.tools import common


class Passes:
    """The count of completed passes over the corpus (epochs)."""

    def __init__(self, n=0):
        self.n = n


def latents_stream(lat, n_train, batch, data_seed, passes, skip=0):
    """Batches [batch, h, w, C] float32 of the first n_train rows of lat (an
    array or a memory map)."""
    n = 0
    while True:
        order = (np.random.default_rng((data_seed, passes.n)).permutation(n_train)
                 if data_seed is not None else np.arange(n_train))
        for i in range(0, n_train - batch + 1, batch):
            n += 1
            if n <= skip:
                continue
            # sorted gather: the same batch, read in the file's order
            yield np.asarray(lat[np.sort(order[i:i + batch])], np.float32)
        passes.n += 1


def synthetic_stream(batch, latent, channels=16, skip=0):
    """Standard-normal latents [batch, latent, latent, channels]; no passes."""
    rng = np.random.default_rng(0)
    n = 0
    while True:
        arr = rng.standard_normal((batch, latent, latent, channels)).astype(np.float32)
        n += 1
        if n <= skip:
            continue
        yield arr


def folder_stream(paths, size, batch, loader, encode, passes, skip=0, what=""):
    """encode(images) of each full batch of the images at ``paths``, pass
    after pass. Raises when a pass yields no full batch."""
    n = 0
    while True:
        yielded = 0
        for imgs, _ in common.file_batches(paths, size, batch, loader):
            if imgs.shape[0] != batch:
                continue
            yielded += 1
            n += 1
            if n <= skip:
                continue
            yield encode(imgs)
        if yielded == 0:
            raise RuntimeError(f"no full batch of {batch} decodable images in {what} "
                               f"({len(paths)} files): lower --batch-size or check the corpus")
        passes.n += 1


def epoch_shards(shards, data_seed, epoch):
    """This rank's shards of an epoch: the global list shuffled by (seed,
    epoch) (kept in order without a seed), then ``process_slice``."""
    cur = native.shuffle_shards(shards, data_seed, epoch) if data_seed is not None else shards
    lo, hi = process_slice(len(cur))
    return cur[lo:hi]


def tar_stream(shards, size, batch, loader, encode, passes, data_seed=None,
               shuffle_buffer=1000, exact=False, skip=0):
    """encode(images) of each full batch of the shards, epoch after epoch.

    The cheap skip (the default) hands the loader ``skip_samples`` = the
    remaining skip in members, so nothing skipped is decoded; a pass shorter
    than the skip advances the count by its own full batches
    (``members_seen // batch``, which counts failed members too). ``exact``
    decodes the skipped batches and drops them. Raises when a pass neither
    yields a batch nor advances the skip (no decodable full batch)."""
    decode = None if loader == "native" else common.pil_bytes
    n = 0
    while True:
        sk = max(0, skip - n)
        n_before = n
        ld = native.TarShardLoader(
            epoch_shards(shards, data_seed, passes.n), size=size, batch=batch,
            seed=data_seed, epoch=passes.n, shard_shuffle=False,
            shuffle_buffer=shuffle_buffer if data_seed is not None else 0,
            skip_samples=0 if exact else sk * batch, decode=decode)
        yielded = 0
        for imgs, _ in ld:
            if imgs.shape[0] != batch:
                continue
            if exact and n - n_before < sk:
                n += 1
                continue
            yielded += 1
            yield encode(imgs)
        if not exact:
            n += min(sk, ld.members_seen // batch)
        n += yielded
        if yielded == 0 and n == n_before:
            raise RuntimeError(f"no full batch of {batch} decodable images in "
                               f"{len(shards)} shards")
        passes.n += 1


def with_epoch_flags(gen, passes):
    """(batch, the number of the epoch this batch completed, or None), by
    drawing one batch ahead: a stream learns that a pass ended only when it
    is asked for the batch after the pass's last. Epochs that end inside a
    resume skip are not announced again."""
    it = iter(gen)
    prev = next(it)
    seen = passes.n
    while True:
        cur = next(it)
        completed = passes.n if passes.n != seen else None
        seen = passes.n
        yield prev, completed
        prev = cur
