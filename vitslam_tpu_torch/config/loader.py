"""Minimal Hydra-semantics config system (port of
vitslam_tpu/config/loader.py): YAML defaults-list inheritance,
``${dotted.path}`` interpolation, ``--set`` overrides applied before
interpolation, and recursive ``_target_`` instantiation.

The shipped ``configs/*.yaml`` name the reference's classes
(``vitslam_tpu.<module>.<Class>``); ``instantiate`` builds the port's class
of the same module path (``vitslam_tpu_torch.<module>.<Class>``), and a
``dtype`` given as a string ("float32", "bfloat16", "float16") becomes the
torch dtype. PyYAML is imported where a file or an override is parsed, so
the module imports without it.
"""
from __future__ import annotations

import importlib
import os.path as osp
import re
from typing import Any

import torch

_INTERP = re.compile(r"^\$\{([^}]+)\}$")
_INTERP_PART = re.compile(r"\$\{([^}]+)\}")


class DotDict(dict):
    """dict with attribute access, recursive."""

    def __getattr__(self, k):
        try:
            v = self[k]
        except KeyError as e:
            raise AttributeError(k) from e
        return v

    def __setattr__(self, k, v):
        self[k] = v

    @staticmethod
    def wrap(obj):
        if isinstance(obj, dict):
            return DotDict({k: DotDict.wrap(v) for k, v in obj.items()})
        if isinstance(obj, list):
            return [DotDict.wrap(v) for v in obj]
        return obj


def load_yaml(path: str) -> dict:
    import yaml

    with open(path) as f:
        return yaml.safe_load(f) or {}


def _deep_merge(base: dict, override: dict) -> dict:
    out = dict(base)
    for k, v in override.items():
        if k in out and isinstance(out[k], dict) and isinstance(v, dict):
            out[k] = _deep_merge(out[k], v)
        else:
            out[k] = v
    return out


def _resolve_path(root: dict, dotted: str):
    node: Any = root
    for part in dotted.split("."):
        node = node[part]
    return node


def _interpolate(node, root):
    if isinstance(node, str):
        m = _INTERP.match(node)
        if m:  # whole-value interpolation preserves type
            return _interpolate(_resolve_path(root, m.group(1)), root)
        return _INTERP_PART.sub(
            lambda mm: str(_resolve_path(root, mm.group(1))), node
        )
    if isinstance(node, dict):
        return {k: _interpolate(v, root) for k, v in node.items()}
    if isinstance(node, list):
        return [_interpolate(v, root) for v in node]
    return node


def set_dotted(cfg, dotted: str, value):
    """Set ``a.b.0.c``-style paths (integers index into lists). Values are
    parsed as YAML when given as strings (hydra override semantics)."""
    keys = dotted.split(".")
    node: Any = cfg
    for k in keys[:-1]:
        node = node[int(k)] if isinstance(node, list) else node[k]
    last = keys[-1]
    if isinstance(value, str):
        import yaml

        value = yaml.safe_load(value)
    if isinstance(node, list):
        node[int(last)] = value
    else:
        node[last] = value


def compose(config_name: str, config_dir: str = "configs",
            overrides=None) -> DotDict:
    """Load <config_dir>/<config_name>.yaml honoring its defaults list,
    apply dotted overrides, then resolve interpolations. Overrides land
    BEFORE interpolation (hydra semantics: training/run_model.py:432-433),
    so ``img_size=140`` propagates into every ``${img_size}`` consumer.
    ``overrides``: dict of dotted-path -> value, or list of "k=v" strings."""
    path = osp.join(config_dir, config_name)
    if not path.endswith(".yaml"):
        path += ".yaml"
    raw = load_yaml(path)
    defaults = raw.pop("defaults", None)
    merged: dict = {}
    if defaults:
        self_seen = False
        for item in defaults:
            if item == "_self_":
                merged = _deep_merge(merged, raw)
                self_seen = True
            else:
                name = item if isinstance(item, str) else list(item.values())[0]
                sub = compose(name, config_dir)
                merged = _deep_merge(merged, sub)
        if not self_seen:
            merged = _deep_merge(merged, raw)
    else:
        merged = raw
    if overrides:
        if isinstance(overrides, dict):
            items = list(overrides.items())
        else:
            items = []
            for ov in overrides:
                key, sep, val = ov.partition("=")
                if not sep:
                    raise ValueError(
                        f"malformed override {ov!r}: expected 'key=value'")
                items.append((key, val))
        for key, val in items:
            set_dotted(merged, key, val)
    merged = _interpolate(merged, merged)
    return DotDict.wrap(merged)


_REF, _PORT = "vitslam_tpu.", "vitslam_tpu_torch."
_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16, "float16": torch.float16}


def _import_target(target: str):
    """The class or function a ``_target_`` names, with a leading
    ``vitslam_tpu.`` read as the port's ``vitslam_tpu_torch.``."""
    if target.startswith(_REF):
        target = _PORT + target[len(_REF):]
    module, _, attr = target.rpartition(".")
    try:
        mod = importlib.import_module(module)
    except ModuleNotFoundError as e:
        if module.startswith(_PORT) and e.name and e.name.startswith(_PORT):
            raise NotImplementedError(
                f"{module} is not ported yet (ROADMAP queue 1); the target {target!r} "
                "has no class in the port") from e
        raise
    return getattr(mod, attr)


def instantiate(node, **overrides):
    """Recursively instantiate a ``_target_`` config node. Nested dicts/
    lists with their own ``_target_`` become objects; plain dicts stay
    dicts. ``_partial_: true`` returns a functools.partial."""
    import functools

    if isinstance(node, list):
        return [instantiate(v) for v in node]
    if not isinstance(node, dict):
        return node
    if "_target_" not in node:
        return {k: instantiate(v) for k, v in node.items()}
    node = dict(node)
    target = _import_target(node.pop("_target_"))
    partial = node.pop("_partial_", False)
    kwargs = {k: instantiate(v) for k, v in node.items()}
    if isinstance(kwargs.get("dtype"), str):
        kwargs["dtype"] = _DTYPES[kwargs["dtype"]]
    kwargs.update(overrides)
    if partial:
        return functools.partial(target, **kwargs)
    return target(**kwargs)
