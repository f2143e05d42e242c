"""Builds the CUDA C++ kernels under ``csrc/`` with ``nvcc`` at first use and
loads them with ``ctypes``.

Each ``.cu`` file has a plain C interface (raw pointers, sizes, strides, the
stream; returns ``cudaGetLastError()``), so no PyTorch header is compiled
and a build takes seconds. One shared library per source, keyed by a hash of
the source and the flags, under ``selftoktokenizer_tpu_torch/build/``. A
build or load failure raises; nothing here falls back to another
implementation.

The host-side image loader (``csrc/dataloader.cc``, C++ with libjpeg and
libpng) is built the same way with ``g++`` (``build_host``), at first use by
``data/native.py`` and not by ``build_all``: a machine without the codec
headers still builds and runs the kernels.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import re
import shutil
import subprocess
import threading

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC_DIR = os.path.join(_PKG, "csrc")
BUILD_DIR = os.path.join(_PKG, "build")

NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC"]

KERNEL_SOURCES = ("vq_argmax", "flash_attention", "flash_attention_tf32", "q8_matmul", "conv3ch")

# the host library's flags and libraries, as the reference's native/Makefile
CXX_FLAGS = ["-O3", "-fPIC", "-std=c++17", "-Wall", "-pthread", "-shared"]

_libs = {}
_lock = threading.Lock()


def _nvcc():
    exe = shutil.which("nvcc")
    if exe is None:
        cand = os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"),
                            "bin", "nvcc")
        if os.path.exists(cand):
            exe = cand
    if exe is None:
        raise RuntimeError(
            "nvcc not found: the CUDA kernels are compiled at first use and "
            "need the CUDA toolkit (looked on PATH and under CUDA_HOME)")
    return exe


_INCLUDE = re.compile(rb'^\s*#\s*include\s+"([^"]+)"', re.M)


def _sources(path, seen=None):
    """The bytes of a source and of every header under csrc/ it includes
    (transitively, each once), in include order."""
    seen = set() if seen is None else seen
    seen.add(path)
    with open(path, "rb") as f:
        text = f.read()
    parts = [text]
    for inc in _INCLUDE.findall(text):
        dep = os.path.join(os.path.dirname(path), inc.decode())
        if dep not in seen and os.path.exists(dep):
            parts.extend(_sources(dep, seen))
    return parts


def _target(name, src=None, flags=NVCC_FLAGS):
    """(source path, library path): the library's name carries a hash of the
    source, the headers it includes and the flags, so a change to any of
    them builds anew."""
    src = src or os.path.join(CSRC_DIR, name + ".cu")
    digest = hashlib.sha256(b"".join(_sources(src)) + " ".join(flags).encode())
    return src, os.path.join(BUILD_DIR, f"lib{name}_{digest.hexdigest()[:16]}.so")


def _start_build(name, verbose=False):
    """Start nvcc for one source unless its library exists. Returns
    (process or None, temporary path, final path)."""
    src, out = _target(name)
    if os.path.exists(out):
        return None, None, out
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = f"{out}.{os.getpid()}.tmp"
    cmd = [_nvcc(), *NVCC_FLAGS, *(["-Xptxas", "-v"] if verbose else []),
           "-o", tmp, src]
    proc = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True)
    return proc, tmp, out


def _finish_build(name, proc, tmp, out, verbose=False):
    if proc is None:
        return out
    log, _ = proc.communicate()
    if proc.returncode != 0:
        if os.path.exists(tmp):
            os.remove(tmp)
        raise RuntimeError(f"nvcc failed for csrc/{name}.cu:\n{log}")
    if verbose and log:
        print(log)
    os.replace(tmp, out)
    return out


def build_all(verbose=False):
    """Build every kernel source, one nvcc each, all started together."""
    with _lock:
        started = [(n, *_start_build(n, verbose)) for n in KERNEL_SOURCES]
        for n, proc, tmp, out in started:
            _finish_build(n, proc, tmp, out, verbose)


def load(name):
    """The ctypes library for ``csrc/<name>.cu``, built on first use."""
    lib = _libs.get(name)
    if lib is not None:
        return lib
    with _lock:
        lib = _libs.get(name)
        if lib is None:
            out = _finish_build(name, *_start_build(name))
            lib = ctypes.CDLL(out)
            _libs[name] = lib
    return lib


def cxx():
    """The host C++ compiler: ``$CXX``, else ``g++``, on PATH; None when
    neither is there."""
    return shutil.which(os.environ.get("CXX", "g++"))


def build_host(src, libs=()):
    """Build the host C++ source ``src`` into a shared library under
    ``build/`` (unless the library for these bytes and flags exists) and
    return its path. A failed build raises with the compiler's message."""
    exe = cxx()
    if exe is None:
        raise RuntimeError("no C++ compiler found ($CXX or g++ on PATH): "
                           f"{os.path.basename(src)} is built at first use")
    name = os.path.splitext(os.path.basename(src))[0]
    flags = [*CXX_FLAGS, *libs]
    src, out = _target(name, src, flags)
    with _lock:
        if os.path.exists(out):
            return out
        os.makedirs(BUILD_DIR, exist_ok=True)
        tmp = f"{out}.{os.getpid()}.tmp"
        proc = subprocess.run([exe, *CXX_FLAGS, src, "-o", tmp, *libs],
                              capture_output=True, text=True)
        if proc.returncode != 0:
            if os.path.exists(tmp):
                os.remove(tmp)
            raise RuntimeError(f"{os.path.basename(exe)} failed for {src}:\n"
                               f"{proc.stdout}{proc.stderr}")
        os.replace(tmp, out)
    return out
