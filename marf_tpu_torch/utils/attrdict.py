"""Attribute-access dictionary for the options tree (the reference threads
one `easydict.EasyDict` through every constructor, reference options.py:38)."""

from __future__ import annotations


class AttrDict(dict):
    """dict subclass with attribute access; nested dicts are converted."""

    def __init__(self, d=None, **kwargs):
        super().__init__()
        d = dict(d or {})
        d.update(kwargs)
        for k, v in d.items():
            self[k] = v

    @staticmethod
    def _convert(value):
        if isinstance(value, dict) and not isinstance(value, AttrDict):
            return AttrDict(value)
        if isinstance(value, (list, tuple)):
            return type(value)(AttrDict._convert(v) for v in value)
        return value

    def __setitem__(self, key, value):
        super().__setitem__(key, AttrDict._convert(value))

    def __setattr__(self, name, value):
        self[name] = value

    def __getattr__(self, name):
        try:
            return self[name]
        except KeyError as exc:
            raise AttributeError(name) from exc

    def __delattr__(self, name):
        try:
            del self[name]
        except KeyError as exc:
            raise AttributeError(name) from exc


def to_plain_dict(d):
    """AttrDicts (and nested dicts, lists) -> plain dicts and lists, for the
    options.yaml snapshot (reference util.py:97-103)."""
    if isinstance(d, dict):
        return {k: to_plain_dict(v) for k, v in d.items()}
    if isinstance(d, (list, tuple)):
        return [to_plain_dict(v) for v in d]
    return d
