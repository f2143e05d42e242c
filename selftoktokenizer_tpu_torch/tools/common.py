"""What the tools share: the choice of image loader, batches of images
with the name of each row, and the device-side copy.

Loaders: ``'native'`` is the C++ loader (``data/native.py``), chosen where
it can be built here (``native_available``: a C++ compiler with the libjpeg
and libpng headers); ``'pil'`` is ``pipeline/preprocess.py``. Both give
float32 NHWC in [-1, 1]; they agree within 3 uint8 levels.

The training drivers also share: the device check (``resolve_device``:
'cuda' without a CUDA device raises), seeded generators (``generator``:
one per (seed, label) tuple, as JAX folds a label into a key), the seeded
SD3 VAE (``seeded_vae``), the encode of images to the tokenizer's latents
and the metrics file writer.
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


# ---------------------------------------------------------------------------
# what the training drivers share
# ---------------------------------------------------------------------------

def resolve_device(name):
    """The torch device a tool runs on: 'cuda' (the default) needs a CUDA
    device and raises without one; 'cpu' only when the caller asks."""
    import torch

    dev = torch.device(name)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"--device {name}: no CUDA device is available; pass "
                           "--device cpu to run on the CPU")
    return dev


def derive_seed(*keys):
    """One 63-bit seed from a tuple of integers (a seed and the labels of a
    use: a step, a stream), as JAX folds a label into a key: the same
    tuple gives the same seed in every process."""
    return int(np.random.SeedSequence([int(k) for k in keys]).generate_state(2, np.uint64)[0]
               >> np.uint64(1))


def generator(device, *keys):
    """A fresh ``torch.Generator`` on ``device`` seeded by ``derive_seed``.
    A driver makes one per step from (seed, step), never one across steps,
    so a resumed run draws what the uninterrupted run drew."""
    import torch

    g = torch.Generator(device=device)
    g.manual_seed(derive_seed(*keys))
    return g


# the label of the seeded SD3 VAE among a config's random_seed uses
VAE_SEED_LABEL = 1


def seeded_vae(random_seed, zero_init_std=0.0):
    """The SD3 VAE at its published widths with the port's seeded init:
    the reference's scheme (``models.tokenizer.init_weights_``) drawn on
    the CPU from ``generator('cpu', random_seed, VAE_SEED_LABEL)``, so
    every device gets the same weights. ``gen_corpus --latents-out`` and
    ``train_tokenizer`` without ``--vae-path`` both encode with it. Returns
    (SDVAE on the CPU in fp32, its VAEConfig)."""
    from selftoktokenizer_tpu_torch.models.tokenizer import init_weights_
    from selftoktokenizer_tpu_torch.models.vae import SDVAE, VAEConfig

    cfg = VAEConfig()
    vae = SDVAE(cfg)
    init_weights_(vae, generator("cpu", random_seed, VAE_SEED_LABEL), zero_init_std)
    return vae, cfg


def bf16_vae(vae, device):
    """A VAE module for encoding / decoding: bf16, on ``device``, frozen."""
    import torch

    return vae.to(device=device, dtype=torch.bfloat16).requires_grad_(False)


def encode_to_latents(vae, cfg, images, device):
    """[-1, 1] NHWC images (numpy or tensor) -> the tokenizer's latents
    ``SD3LatentFormat.process_in(vae_encode_mode(...))`` in fp32 on
    ``device``; the VAE (bf16, see ``bf16_vae``) encodes in bf16 and the
    format's affine map runs on the bf16 result, as the pipeline's encode
    does."""
    import torch

    from selftoktokenizer_tpu_torch.models.vae import SD3LatentFormat, vae_encode_mode

    with torch.no_grad():
        x = native.to_device(images, device).to(torch.bfloat16)
        return SD3LatentFormat.process_in(vae_encode_mode(vae, cfg, x)).float()


def metrics_writer(path):
    """A function appending one JSON line per record to ``path`` (the file
    opened and closed around each record); a no-op when path is None."""
    import json

    def emit(rec):
        if path is not None:
            with open(path, "a") as f:
                f.write(json.dumps(rec) + "\n")
    return emit


def log(msg):
    print(msg, flush=True)


# ---------------------------------------------------------------------------
# what the measurement tools share
# ---------------------------------------------------------------------------

def card_line(device):
    """The card's name and power limit as ``nvidia-smi
    --query-gpu=name,power.limit --format=csv,noheader`` gives them, for a
    CUDA device (its name alone where nvidia-smi cannot be run); 'cpu' on
    the CPU. Every number a tool prints stands beside it."""
    import subprocess

    import torch

    dev = torch.device(device)
    if dev.type != "cuda":
        return "cpu"
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader",
                              f"--id={dev.index or 0}"], capture_output=True, text=True, timeout=60)
        if out.returncode == 0 and out.stdout.strip():
            return out.stdout.strip().splitlines()[0].strip()
    except (OSError, subprocess.SubprocessError):
        pass
    return torch.cuda.get_device_name(dev)


def seeded_pipeline(cfg, device, **kw):
    """A ``SelftokPipeline`` of ``cfg`` (a config or a yml path) on
    ``device`` with the port's seeded weights (seed 0) and non-zero adaLN
    and biases (``zero_init_std=0.02``): the reference's zero adaLN gates
    switch every attention off, which would hide the attention from what a
    tool measures. kw: the pipeline's other arguments."""
    from selftoktokenizer_tpu_torch.core.config import load_config
    from selftoktokenizer_tpu_torch.pipeline import SelftokPipeline

    if isinstance(cfg, str):
        cfg = load_config(cfg)
    return SelftokPipeline(cfg, device=device, seed=0, zero_init_std=0.02, **kw)


def uniform_images(batch, size, device, seed=0):
    """[batch, size, size, 3] float32 in [-1, 1] from numpy's default_rng(seed),
    as the reference's tools draw them, on ``device``."""
    import torch

    a = np.random.default_rng(seed).uniform(-1, 1, (batch, size, size, 3)).astype(np.float32)
    return torch.from_numpy(a).to(device)


def random_ids(batch, k, vocab, device, seed=0):
    """[batch, k] int32 ids from numpy's default_rng(seed).integers(0, vocab)."""
    import torch

    a = np.random.default_rng(seed).integers(0, vocab, (batch, k)).astype(np.int32)
    return torch.from_numpy(a).to(device)


def emit(line):
    """Print the tool's JSON line and return it."""
    import json

    print(json.dumps(line), flush=True)
    return line
