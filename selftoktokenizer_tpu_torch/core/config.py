"""Config system: YAML -> attribute-access dict, with the reference's
``common / tokenizer.params`` schema (configs/res256/256-eval.yml of
selftok-team/SelftokTokenizer).

The port's own copy of the reference package's ``core/config.py`` (the port
imports nothing of that package).
"""

from __future__ import annotations

import copy
import os

import yaml

FLAGSHIP_CONFIG = os.path.join(
    os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
    "configs", "flagship-256.yml")


class AttrDict(dict):
    """A dict with attribute access, recursively wrapping nested dicts."""

    def __init__(self, d=None, **kwargs):
        super().__init__()
        d = dict(d or {}, **kwargs)
        for k, v in d.items():
            self[k] = self._wrap(v)

    @classmethod
    def _wrap(cls, v):
        if isinstance(v, dict) and not isinstance(v, AttrDict):
            return cls(v)
        if isinstance(v, (list, tuple)):
            return type(v)(cls._wrap(x) for x in v)
        return v

    def __getattr__(self, name):
        try:
            return self[name]
        except KeyError as e:
            raise AttributeError(name) from e

    def __setattr__(self, name, value):
        self[name] = value

    def __setitem__(self, key, value):
        super().__setitem__(key, self._wrap(value))

    def update(self, *args, **kwargs):
        for k, v in dict(*args, **kwargs).items():
            self[k] = v

    def __delattr__(self, name):
        try:
            del self[name]
        except KeyError as e:
            raise AttributeError(name) from e

    def __deepcopy__(self, memo):
        return AttrDict({k: copy.deepcopy(v, memo) for k, v in self.items()})

    def to_dict(self):
        out = {}
        for k, v in self.items():
            if isinstance(v, AttrDict):
                v = v.to_dict()
            elif isinstance(v, (list, tuple)):
                v = type(v)(x.to_dict() if isinstance(x, AttrDict) else x for x in v)
            out[k] = v
        return out


def none_str(v):
    """YAML 'None' strings -> real None: the reference configs spell None as
    a bare `None`, which YAML parses as the string 'None'."""
    return None if v in (None, "None", "") else v


def load_config(path: str) -> AttrDict:
    """Parse a YAML config file."""
    with open(path, "r") as f:
        raw = yaml.safe_load(f)
    return AttrDict(raw)
