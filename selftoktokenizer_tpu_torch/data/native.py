"""ctypes bindings of the C++ image loader (``csrc/dataloader.cc``), and the
loaders over it (counterpart of the reference ``data/native.py``).

The library decodes JPEG and PNG (libjpeg, libpng), resizes the shortest
side bilinearly, centre-crops and normalises to float32 NHWC in [-1, 1] on a
pool of C++ threads, with no Python in the image path. ``ops/_build.py``
builds it with ``g++`` at first use into ``build/``. Unlike the reference,
nothing here falls back to PIL: a failed build raises with the compiler's
message. ``native_available`` says, from what is installed and without
building, whether the build can run; the tools choose the PIL loader
(``pipeline/preprocess.py``) when it cannot.

Outputs stay numpy float32 NHWC on the host; the caller moves them to the
device (a pinned copy and a non-blocking transfer: ``to_device``).
"""

from __future__ import annotations

import ctypes
import os
import subprocess
import threading

import numpy as np
import torch

from selftoktokenizer_tpu_torch.ops import _build

SOURCE = os.path.join(_build.CSRC_DIR, "dataloader.cc")
LIBS = ("-ljpeg", "-lpng")

_lib = None
_lib_lock = threading.Lock()
_reason = None          # '' once the headers were found


def native_available():
    """Whether the loader can be built here: a C++ compiler that finds
    ``jpeglib.h`` and ``png.h`` (one preprocessor pass over the two
    includes, read once a process). Decided from what is installed; the
    build itself raises if it fails."""
    return unavailable_reason() is None


def unavailable_reason():
    """None where the loader can be built here, else why not: no C++
    compiler, or the preprocessor's first error over the two includes."""
    global _reason
    if _reason is None:
        exe = _build.cxx()
        if exe is None:
            _reason = "no C++ compiler ($CXX or g++) on PATH"
        else:
            out = subprocess.run(
                [exe, "-E", "-x", "c++", "-", "-o", os.devnull],
                input="#include <cstdio>\n#include <jpeglib.h>\n#include <png.h>\n",
                capture_output=True, text=True)
            errors = [ln.strip() for ln in out.stderr.splitlines() if "error" in ln]
            _reason = "" if out.returncode == 0 else (
                (errors or out.stderr.strip().splitlines() or ["the preprocessor failed"])[0])
    return _reason or None


def _bind(lib):
    """Declare the C interface's argument and result types on ``lib``."""
    c_float_p = ctypes.POINTER(ctypes.c_float)
    lib.stk_preprocess_file.restype = ctypes.c_int
    lib.stk_preprocess_file.argtypes = [ctypes.c_char_p, ctypes.c_int, c_float_p]
    lib.stk_preprocess_bytes.restype = ctypes.c_int
    lib.stk_preprocess_bytes.argtypes = [ctypes.c_char_p, ctypes.c_long, ctypes.c_int,
                                         c_float_p]
    lib.stk_loader_create.restype = ctypes.c_void_p
    lib.stk_loader_create.argtypes = [ctypes.POINTER(ctypes.c_char_p), ctypes.c_long,
                                      ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int]
    lib.stk_loader_next.restype = ctypes.c_int
    lib.stk_loader_next.argtypes = [ctypes.c_void_p, c_float_p,
                                    ctypes.POINTER(ctypes.c_long)]
    lib.stk_loader_destroy.restype = None
    lib.stk_loader_destroy.argtypes = [ctypes.c_void_p]
    lib.stk_loader_stats.restype = ctypes.c_long
    lib.stk_loader_stats.argtypes = [ctypes.c_void_p, ctypes.POINTER(ctypes.c_long)]
    return lib


def load_library():
    """The bound library, built from ``SOURCE`` on first use; raises when
    the build fails."""
    global _lib
    with _lib_lock:
        if _lib is None:
            _lib = _bind(ctypes.CDLL(_build.build_host(SOURCE, LIBS)))
        return _lib


def _f32_ptr(a):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_float))


def preprocess_file(path, size):
    """An image file -> float32 [1, size, size, 3] in [-1, 1] by the C++
    path. Raises IOError when the file does not decode."""
    out = np.empty((size, size, 3), np.float32)
    if not load_library().stk_preprocess_file(os.fsencode(path), size, _f32_ptr(out)):
        raise IOError(f"native decode failed: {path}")
    return out[None]


def preprocess_bytes(data, size):
    """Encoded image bytes -> float32 [1, size, size, 3] in [-1, 1] by the
    C++ path. Raises IOError when they do not decode."""
    out = np.empty((size, size, 3), np.float32)
    if not load_library().stk_preprocess_bytes(data, len(data), size, _f32_ptr(out)):
        raise IOError("native bytes decode failed")
    return out[None]


def to_device(images, device):
    """A batch (numpy or tensor) -> a tensor on ``device``; from the host
    to a CUDA device through pinned memory and a non-blocking copy."""
    t = images if torch.is_tensor(images) else torch.from_numpy(images)
    if t.device.type == "cpu" and torch.device(device).type == "cuda":
        return t.pin_memory().to(device, non_blocking=True)
    return t.to(device)


_IMG_EXT = (".jpg", ".jpeg", ".png")


def shuffle_shards(shards, seed, epoch=0):
    """The shard list permuted by (seed, epoch), webdataset's shard shuffle.
    A multi-rank caller permutes the global list with this, then takes its
    ``parallel.distributed.process_slice``."""
    order = np.random.default_rng([int(seed), int(epoch)]).permutation(len(shards))
    return [shards[i] for i in order]


class TarShardLoader:
    """webdataset-style ingestion of plain tar shards of images.

    Each shard streams sequentially; members decode through the C++ bytes
    path on a small thread pool and gather into [batch, size, size, 3]
    float32 batches in [-1, 1]. For several ranks, split the shard list
    (``process_slice`` of the shards) before building the loader.

    * ``seed`` (with ``epoch``): shuffles this loader's shard list (unless
      ``shard_shuffle=False``: the caller permuted the global list) and
      seeds the sample shuffle buffer.
    * ``shuffle_buffer=B``: a streaming shuffle, a B-slot buffer over the
      member stream that emits a random slot per incoming member, seeded
      ``[seed, epoch, 1]``; reads stay sequential.
    * ``skip_samples=N``: resume mid-epoch: the first N members of the
      (shuffled) stream are dropped without being decoded.
    * ``decode``: (bytes, size) -> [1, size, size, 3]; None is the C++
      path (``preprocess_bytes``, built on first use). A decoder signals
      a member that does not decode by raising OSError.

    Yields (images, keys), keys like ``'shard-0000/member.jpg'``. Members
    that fail to decode are dropped and counted in ``stats()``;
    ``members_seen`` counts every streamed member (skipped, decoded or
    failed). Both are reset at the start of each pass. At most
    max(2 * n_threads, batch) decodes are in flight, so the stream never
    holds every shard's bytes at once.
    """

    def __init__(self, shards, size=256, batch=16, n_threads=4, seed=None,
                 epoch=0, shuffle_buffer=0, skip_samples=0, shard_shuffle=True,
                 decode=None):
        self.shards = list(shards)
        self.decode = decode
        if seed is not None and shard_shuffle:
            self.shards = shuffle_shards(self.shards, seed, epoch)
        self.size, self.batch = size, batch
        self.n_threads = n_threads
        self.seed, self.epoch = seed, epoch
        self.shuffle_buffer = shuffle_buffer
        self.skip_samples = skip_samples
        self.members_seen = 0
        self._decoded = 0
        self._failed = 0

    def stats(self):
        return {"decoded": self._decoded, "failed": self._failed}

    def _decode(self, item):
        name, data = item
        try:
            return name, (self.decode or preprocess_bytes)(data, self.size)
        except OSError:
            return name, None

    def __iter__(self):
        import tarfile
        from collections import deque
        from concurrent.futures import ThreadPoolExecutor

        if self.decode is None:
            load_library()     # a failed build raises here, not as failed decodes
        self.members_seen = 0
        self._decoded = 0
        self._failed = 0

        def members():
            for shard in self.shards:
                base = os.path.splitext(os.path.basename(shard))[0]
                with tarfile.open(shard, "r|*") as tf:  # streaming mode
                    for m in tf:
                        if not m.isfile() or not m.name.lower().endswith(_IMG_EXT):
                            continue
                        f = tf.extractfile(m)
                        if f is None:
                            continue
                        self.members_seen += 1
                        yield f"{base}/{m.name}", f.read()

        def shuffled():
            # over the raw members, before decoding, so a resume skip never
            # pays for a decode
            if self.shuffle_buffer <= 0:
                yield from members()
                return
            rng = np.random.default_rng([int(self.seed or 0), int(self.epoch), 1])
            buf = []
            for item in members():
                if len(buf) < self.shuffle_buffer:
                    buf.append(item)
                    continue
                j = int(rng.integers(len(buf)))
                out, buf[j] = buf[j], item
                yield out
            while buf:  # drain in random order
                j = int(rng.integers(len(buf)))
                buf[j], buf[-1] = buf[-1], buf[j]
                yield buf.pop()

        def stream():
            it = shuffled()
            for _ in range(self.skip_samples):
                if next(it, None) is None:
                    return
            yield from it

        def decoded():
            window = max(2 * self.n_threads, self.batch)
            pending = deque()
            with ThreadPoolExecutor(self.n_threads) as pool:
                for item in stream():
                    pending.append(pool.submit(self._decode, item))
                    if len(pending) >= window:
                        yield pending.popleft().result()
                while pending:
                    yield pending.popleft().result()

        imgs, keys = [], []
        for name, arr in decoded():
            if arr is None:
                self._failed += 1
                continue
            self._decoded += 1
            imgs.append(arr)
            keys.append(name)
            if len(imgs) == self.batch:
                yield np.concatenate(imgs), keys
                imgs, keys = [], []
        if imgs:
            yield np.concatenate(imgs), keys


class NativeImageLoader:
    """Prefetching batch iterator over image paths: C++ worker threads
    decode into a bounded ring of ready batches.

    Yields float32 [n, size, size, 3] arrays (n < batch at the tail or
    where decodes failed; failed decodes are counted in ``stats()``).
    Batches complete in worker order, not path order: use
    ``next_with_indices()`` (or ``last_indices`` after ``__next__``) to
    pair rows with paths. Builds the library on first use (raises if the
    build fails); ``close()`` stops the workers.
    """

    def __init__(self, paths, size=256, batch=16, n_threads=4, queue_cap=4):
        self._lib = load_library()
        self.size, self.batch = size, batch
        self._cpaths = (ctypes.c_char_p * len(paths))(*[os.fsencode(p) for p in paths])
        self._h = self._lib.stk_loader_create(self._cpaths, len(paths), size, batch,
                                              n_threads, queue_cap)
        self._buf = np.empty((batch, size, size, 3), np.float32)
        self._idx = np.empty((batch,), np.int64)
        self.last_indices = None

    def __iter__(self):
        return self

    def __next__(self):
        return self.next_with_indices()[0]

    def next_with_indices(self):
        """(images [n, size, size, 3], the source path index of each row
        [n]); StopIteration when every path is done."""
        if not self._h:
            raise StopIteration
        while True:
            n = self._lib.stk_loader_next(
                self._h, _f32_ptr(self._buf),
                self._idx.ctypes.data_as(ctypes.POINTER(ctypes.c_long)))
            if n < 0:
                raise StopIteration
            if n == 0:
                # a worker whose decodes all failed pushes an empty batch
                continue
            self.last_indices = self._idx[:n].copy()
            return self._buf[:n].copy(), self.last_indices

    def stats(self):
        """{'decoded': n, 'failed': n} so far (their last values after
        ``close``)."""
        if not self._h:
            return dict(self._closed_stats)
        failed = ctypes.c_long(0)
        decoded = self._lib.stk_loader_stats(self._h, ctypes.byref(failed))
        return {"decoded": int(decoded), "failed": int(failed.value)}

    def close(self):
        if getattr(self, "_h", None):
            self._closed_stats = self.stats()
            self._lib.stk_loader_destroy(self._h)
            self._h = None

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()

    def __del__(self):
        self.close()
