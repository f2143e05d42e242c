"""Image input of the port against the JAX package's, on the CPU: PIL
preprocessing bit for bit, the C++ loader (the port's ``csrc/dataloader.cc``
built by ``ops/_build.py``) bit for bit against the JAX package's
``native/dataloader.cc`` compiled here with g++ into a temporary directory
(never ``make -C native``: parallel test workers would write one file), and
within 3 uint8 levels of PIL; the tar shard stream's order, the prefetch
loader's row indices, failed decodes, and a build that fails."""

import ctypes
import io
import os
import subprocess
import tarfile
from unittest import mock

import numpy as np
import pytest
from PIL import Image

from selftoktokenizer_tpu.data import native as j_native
from selftoktokenizer_tpu.pipeline import preprocess as j_pre
from selftoktokenizer_tpu_torch.data import native
from selftoktokenizer_tpu_torch.ops import _build
from selftoktokenizer_tpu_torch.pipeline import preprocess as pre
from selftoktokenizer_tpu_torch.tools import common

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SIZE = 48
MODES = ("rgb.png", "gray.png", "rgba.png", "palette.png", "rgb.jpg", "gray.jpg")


def _write(path, kind, w, h, rng):
    rgb = rng.integers(0, 256, (h, w, 3), dtype=np.uint8)
    img = {"rgb": lambda: Image.fromarray(rgb),
           "gray": lambda: Image.fromarray(rgb[..., 0]),
           "rgba": lambda: Image.fromarray(np.concatenate(
               [rgb, rng.integers(0, 256, (h, w, 1), dtype=np.uint8)], -1)),
           "palette": lambda: Image.fromarray(rgb).quantize(colors=37)}[kind]()
    img.save(path, quality=92) if path.endswith(".jpg") else img.save(path)


@pytest.fixture(scope="module")
def images(tmp_path_factory):
    """Every mode at several sizes (landscape, portrait, odd crop offsets,
    upscaling), in sorted order."""
    d = tmp_path_factory.mktemp("imgs")
    rng = np.random.default_rng(0)
    paths = []
    for i, (w, h) in enumerate([(101, 67), (40, 90), (48, 48), (130, 97)]):
        for m in MODES:
            kind, ext = m.split(".")
            p = str(d / f"im{i}_{kind}.{ext}")
            _write(p, kind, w, h, rng)
            paths.append(p)
    return sorted(paths)


@pytest.fixture(scope="module")
def jax_lib(tmp_path_factory):
    """The JAX package's loader source, compiled here with the flags of its
    Makefile, bound with the port's argument types."""
    out = str(tmp_path_factory.mktemp("jaxlib") / "libselftok_data.so")
    subprocess.run(["g++", *_build.CXX_FLAGS, os.path.join(REPO, "native", "dataloader.cc"),
                    "-o", out, "-ljpeg", "-lpng"], check=True, capture_output=True)
    return native._bind(ctypes.CDLL(out))


def test_pil_path_is_bit_equal_to_jax(images):
    for p in images:
        np.testing.assert_array_equal(pre.load_image(p, SIZE), j_pre.load_image(p, SIZE), p)
        img = Image.open(p)            # the mode as stored: L, RGBA, P, RGB
        got = pre.preprocess_pil(img, SIZE)
        np.testing.assert_array_equal(got, j_pre.preprocess_pil(Image.open(p), SIZE), p)
        assert got.shape == (1, SIZE, SIZE, 3) and got.dtype == np.float32
        data = open(p, "rb").read()
        np.testing.assert_array_equal(common.pil_bytes(data, SIZE), got, p)
    x = np.random.default_rng(1).uniform(-0.1, 1.1, (2, 8, 8, 3)).astype(np.float32)
    np.testing.assert_array_equal(pre.to_uint8(x), j_pre.to_uint8(x))


def test_pil_save_image_round_trip(tmp_path):
    x = np.random.default_rng(2).uniform(0, 1, (1, 16, 12, 3)).astype(np.float32)
    pre.save_image(x, str(tmp_path / "a.png"))
    j_pre.save_image(x, str(tmp_path / "b.png"))
    a, b = (np.asarray(Image.open(tmp_path / n)) for n in ("a.png", "b.png"))
    np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(a, pre.to_uint8(x)[0])


def test_cpp_decode_is_bit_equal_to_jax_and_near_pil(images, jax_lib):
    assert native.native_available()
    for p in images:
        got = native.preprocess_file(p, SIZE)
        want = np.empty((SIZE, SIZE, 3), np.float32)
        assert jax_lib.stk_preprocess_file(p.encode(), SIZE, native._f32_ptr(want)) == 1
        np.testing.assert_array_equal(got[0], want, p)
        data = open(p, "rb").read()
        np.testing.assert_array_equal(native.preprocess_bytes(data, SIZE), got, p)
        assert got.shape == (1, SIZE, SIZE, 3)
        # bilinear filters of PIL and the C++ path round at other places
        diff = np.abs(got - pre.load_image(p, SIZE)).max() * 127.5
        assert diff <= 3.0, (p, diff)


def _shards(images, tmp_path, n=3, bad=()):
    """n tar shards of the images (and a text member, which is skipped);
    ``bad``: member names holding bytes that decode as no image."""
    out, per = [], -(-len(images) // n)
    for s in range(n):
        sp = str(tmp_path / f"shard-{s:04d}.tar")
        with tarfile.open(sp, "w") as tf:
            for p in images[s * per:(s + 1) * per]:
                tf.add(p, arcname=os.path.basename(p))
            info = tarfile.TarInfo("notes.txt")
            info.size = 3
            tf.addfile(info, io.BytesIO(b"abc"))
            for name in bad if s == 0 else ():
                info = tarfile.TarInfo(name)
                info.size = 64
                tf.addfile(info, io.BytesIO(b"\xff\xd8" + bytes(62)))
        out.append(sp)
    return out


@pytest.mark.parametrize("seed,epoch,shuffle_buffer,skip", [
    (None, 0, 0, 0), (3, 0, 0, 0), (3, 1, 5, 0), (3, 2, 7, 9), (None, 0, 0, 4)])
def test_tar_stream_matches_jax(images, tmp_path, seed, epoch, shuffle_buffer, skip):
    shards = _shards(images, tmp_path, bad=("broken.jpg",))
    kw = dict(size=SIZE, batch=5, n_threads=2, seed=seed, epoch=epoch,
              shuffle_buffer=shuffle_buffer, skip_samples=skip)
    loader = native.TarShardLoader(shards, **kw)
    got = [(imgs, list(keys)) for imgs, keys in loader]
    # the JAX loader's stream logic with the port's C++ decode, so neither
    # side loads the JAX package's library
    with mock.patch.object(j_native, "preprocess_bytes", native.preprocess_bytes):
        jl = j_native.TarShardLoader(shards, **kw)
        want = [(imgs, list(keys)) for imgs, keys in jl]
    assert [k for _, k in got] == [k for _, k in want]
    for (a, _), (b, _) in zip(got, want):
        np.testing.assert_array_equal(a, b)
    assert loader.members_seen == jl.members_seen == len(images) + 1
    assert loader.stats() == jl.stats()
    keys = [k for _, ks in got for k in ks]
    assert len(keys) == loader.stats()["decoded"] and len(set(keys)) == len(keys)
    if skip == 0:
        assert loader.stats() == {"decoded": len(images), "failed": 1}
        if seed is None:
            assert keys[0] == "shard-0000/" + os.path.basename(images[0])
    # a second pass starts its counts anew and yields the same stream
    again = [list(k) for _, k in loader]
    assert again == [k for _, k in got] and loader.members_seen == len(images) + 1


def test_shuffle_shards_matches_jax():
    shards = [f"s{i}.tar" for i in range(11)]
    for seed, epoch in ((0, 0), (5, 3), (123, 1)):
        assert native.shuffle_shards(shards, seed, epoch) == \
            j_native.shuffle_shards(shards, seed, epoch)


def test_tar_stream_with_the_pil_decoder(images, tmp_path):
    shards = _shards(images, tmp_path, n=2, bad=("broken.png",))
    loader = native.TarShardLoader(shards, size=SIZE, batch=4, decode=common.pil_bytes)
    rows = {k: a for imgs, keys in loader for k, a in zip(keys, imgs)}
    assert loader.stats() == {"decoded": len(images), "failed": 1}
    for p in images:
        k = [k for k in rows if k.endswith("/" + os.path.basename(p))]
        np.testing.assert_array_equal(rows[k[0]], pre.load_image(p, SIZE)[0])


def test_prefetch_loader_indices_match_rows(images):
    paths = images * 2
    seen = []
    with native.NativeImageLoader(paths, size=SIZE, batch=3, n_threads=3) as ld:
        while True:
            try:
                imgs, idx = ld.next_with_indices()
            except StopIteration:
                break
            assert imgs.shape == (len(idx), SIZE, SIZE, 3)
            for row, i in zip(imgs, idx):
                np.testing.assert_array_equal(row, native.preprocess_file(paths[i], SIZE)[0])
            seen += idx.tolist()
        assert sorted(seen) == list(range(len(paths)))
        assert ld.stats() == {"decoded": len(paths), "failed": 0}
    assert ld.stats() == {"decoded": len(paths), "failed": 0}     # kept after close


def test_failed_decodes_are_counted_and_an_empty_batch_skipped(images, tmp_path):
    bad = []
    for i in range(2):
        p = tmp_path / f"bad{i}.png"
        p.write_bytes(b"\x89PNG\r\n\x1a\n" + bytes(40))
        bad.append(str(p))
    missing = str(tmp_path / "missing.jpg")
    good = images[:5]
    # batch 2: the worker slice [bad0, bad1] decodes nothing and is skipped
    paths = [good[0], good[1], *bad, good[2], missing, good[3], good[4]]
    ld = native.NativeImageLoader(paths, size=SIZE, batch=2, n_threads=2)
    rows = []
    while True:
        try:
            imgs, idx = ld.next_with_indices()
        except StopIteration:
            break
        assert len(idx) > 0
        rows += idx.tolist()
    assert sorted(rows) == [0, 1, 4, 6, 7]
    assert ld.stats() == {"decoded": 5, "failed": 3}
    ld.close()
    with pytest.raises(IOError):
        native.preprocess_file(bad[0], SIZE)
    with pytest.raises(IOError):
        native.preprocess_bytes(b"not an image", SIZE)


def test_tool_batches_carry_their_names(images):
    for loader in ("native", "pil"):
        load = common.load_fn(loader)
        n = 0
        for imgs, names in common.file_batches(images, SIZE, 4, loader):
            for row, name in zip(imgs, names):
                np.testing.assert_array_equal(row, load(str(name), SIZE)[0])
            n += len(names)
        assert n == len(images)


def test_a_source_that_does_not_build_raises(tmp_path, monkeypatch):
    src = tmp_path / "broken_loader.cc"
    src.write_text('extern "C" int stk_preprocess_file( { return 0; }\n')
    with pytest.raises(RuntimeError, match="broken_loader.cc"):
        _build.build_host(str(src))
    monkeypatch.setattr(native, "SOURCE", str(src))
    monkeypatch.setattr(native, "_lib", None)
    with pytest.raises(RuntimeError, match="error"):
        native.preprocess_file(__file__, SIZE)
    with pytest.raises(RuntimeError, match="error"):
        next(iter(native.TarShardLoader([], size=SIZE)))
