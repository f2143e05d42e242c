"""Filesystem and serialization helpers (counterpart of the reference
``utils/io.py``): ``mkdirs``, the pickle and yaml helpers, and the sorted
recursive file walk that the tools list their inputs with."""

from __future__ import annotations

import os
import pickle

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
