"""Filesystem and serialization helpers (counterpart of the reference
``utils/io.py``): ``mkdirs``, the pickle and yaml helpers, the sorted
recursive file walk that the tools list their inputs with, and the
``.safetensors`` format read and written by hand (no ``safetensors``
package needed)."""

from __future__ import annotations

import os
import pickle

import numpy as np
import yaml


def mkdirs(path):
    os.makedirs(path, exist_ok=True)
    return path


def pickle_dump(obj, path):
    with open(path, "wb") as f:
        pickle.dump(obj, f)


def pickle_load(path):
    """Unpickle a file this program wrote (unpickling runs code)."""
    with open(path, "rb") as f:
        return pickle.load(f)


def write_to_yaml(obj, path):
    with open(path, "w") as f:
        yaml.safe_dump(obj, f)


def read_from_yaml(path):
    with open(path, "r") as f:
        return yaml.safe_load(f)


def walk_all_files(root, suffixes=None):
    """Every file under ``root``, recursively and sorted; with
    ``suffixes``, only names ending (case-insensitively) in one of them."""
    out = []
    for dirpath, _, files in os.walk(root):
        for fn in files:
            if suffixes is None or fn.lower().endswith(tuple(suffixes)):
                out.append(os.path.join(dirpath, fn))
    return sorted(out)


# ---------------------------------------------------------------------------
# .safetensors, by hand: 8 bytes of little-endian header length, a JSON
# header {name: {"dtype", "shape", "data_offsets": [begin, end]}} (offsets
# into the data that follows; an optional "__metadata__" entry of strings),
# then the raw little-endian bytes of every tensor
# ---------------------------------------------------------------------------

_ST_DTYPES = {"F64": "float64", "F32": "float32", "F16": "float16", "BF16": "bfloat16",
              "I64": "int64", "I32": "int32", "I16": "int16", "I8": "int8", "U8": "uint8",
              "BOOL": "bool"}


def _torch_dtype(name):
    import torch

    return getattr(torch, name)


def save_safetensors(tensors, path, metadata=None):
    """Write {name: torch tensor or numpy array} as one .safetensors file."""
    import json

    import torch

    names = sorted(tensors)
    blobs, header, offset = [], {}, 0
    codes = {v: k for k, v in _ST_DTYPES.items()}
    for name in names:
        t = tensors[name]
        t = torch.from_numpy(np.array(t)) if isinstance(t, np.ndarray) else t
        t = t.detach().cpu().contiguous()
        dt = str(t.dtype).replace("torch.", "")
        if dt not in codes:
            raise TypeError(f"save_safetensors: {name} has the unsupported type {t.dtype}")
        raw = t.reshape(-1).view(torch.uint8).numpy().tobytes() if t.numel() else b""
        header[name] = {"dtype": codes[dt], "shape": list(t.shape),
                        "data_offsets": [offset, offset + len(raw)]}
        blobs.append(raw)
        offset += len(raw)
    if metadata:
        header["__metadata__"] = {str(k): str(v) for k, v in metadata.items()}
    head = json.dumps(header, separators=(",", ":")).encode()
    head += b" " * (-len(head) % 8)          # the data starts 8-byte aligned
    with open(path, "wb") as f:
        f.write(len(head).to_bytes(8, "little"))
        f.write(head)
        for raw in blobs:
            f.write(raw)


def load_safetensors(path):
    """{name: CPU torch tensor} of a .safetensors file."""
    import json

    import torch

    with open(path, "rb") as f:
        n = int.from_bytes(f.read(8), "little")
        header = json.loads(f.read(n))
        data = f.read()
    out = {}
    for name, spec in header.items():
        if name == "__metadata__":
            continue
        if spec["dtype"] not in _ST_DTYPES:
            raise TypeError(f"load_safetensors: {name} has the unsupported type {spec['dtype']}")
        begin, end = spec["data_offsets"]
        buf = bytearray(data[begin:end])
        flat = torch.frombuffer(buf, dtype=torch.uint8) if buf else torch.empty(0, dtype=torch.uint8)
        out[name] = flat.view(_torch_dtype(_ST_DTYPES[spec["dtype"]])).reshape(spec["shape"])
    return out


def load_state_dict_file(path):
    """{name: CPU tensor} of a .pth / .pt (a ``state_dict`` entry when the
    file holds one; only the tensors) or of a .safetensors file."""
    if path.endswith(".safetensors"):
        return load_safetensors(path)
    import torch

    sd = torch.load(path, map_location="cpu", weights_only=False)
    if isinstance(sd, dict) and "state_dict" in sd:
        sd = sd["state_dict"]
    return {k: v for k, v in sd.items() if torch.is_tensor(v)}
