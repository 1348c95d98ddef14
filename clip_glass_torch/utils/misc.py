"""Small CLI / config conveniences matching the reference's grab-bag
helpers (reference stylegan2/utils.py:29-67 AttributeDict, :107-115
to_list, :184-193 bool_type, :195-206 range_type). The package itself
uses typed dataclass configs (config.py) and argparse; these exist so
scripts written against the reference's idioms run unchanged. The port's
own copy of the JAX package's `utils/misc.py` (no JAX in either)."""

from __future__ import annotations

import argparse
import re


class AttributeDict(dict):
    """Dict with attribute-style access (the reference's EasyDict clone,
    stylegan2/utils.py:29). Pickles as a plain dict."""

    def __getattr__(self, name):
        try:
            return self[name]
        except KeyError:
            raise AttributeError(name) from None

    def __setattr__(self, name, value):
        self[name] = value

    def __delattr__(self, name):
        try:
            del self[name]
        except KeyError:
            raise AttributeError(name) from None

    def __getstate__(self):
        return dict(self)

    def __setstate__(self, state):
        self.update(state)

    def __repr__(self):
        body = ", ".join(f"{k}={v}" for k, v in self.items())
        return f"{type(self).__name__}({body})"

    @classmethod
    def convert_dict_recursive(cls, obj):
        """Recursively wrap every plain dict in an AttributeDict
        (reference stylegan2/utils.py:59-66)."""
        if isinstance(obj, dict):
            for key in list(obj.keys()):
                obj[key] = cls.convert_dict_recursive(obj[key])
            if not isinstance(obj, cls):
                return cls(**obj)
        return obj


def to_list(values) -> list:
    """None -> [], scalar -> [scalar], tuple/list -> list (reference
    stylegan2/utils.py:107)."""
    if values is None:
        return []
    if isinstance(values, tuple):
        return list(values)
    if not isinstance(values, list):
        return [values]
    return values


def bool_type(v) -> bool:
    """argparse bool coercion accepting yes/no/true/false/t/f/y/n/1/0
    (reference stylegan2/utils.py:184)."""
    if isinstance(v, bool):
        return v
    if v.lower() in ("yes", "true", "t", "y", "1"):
        return True
    if v.lower() in ("no", "false", "f", "n", "0"):
        return False
    raise argparse.ArgumentTypeError("Boolean value expected.")


_RANGE_RE = re.compile(r"^(\d+)-(\d+)$")


def range_type(s: str):
    """'a-c' -> range(a, c+1); 'a,b,c' -> [a, b, c] (reference
    stylegan2/utils.py:195)."""
    m = _RANGE_RE.match(s)
    if m:
        return range(int(m.group(1)), int(m.group(2)) + 1)
    return [int(x) for x in s.split(",")]
