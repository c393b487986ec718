"""Lightweight hierarchical config with YAML round-tripping and
OmegaConf-style ``${...}`` interpolation.

A copy of ``dmlcloud_tpu/utils/config.py`` (host Python; the port imports
nothing of the JAX package). A dict-like, attribute-accessible,
YAML-serialisable config container supporting the OmegaConf idioms —

- ``${a.b.c}``: reference to another key (absolute dotted path from the
  root), resolved at ACCESS time with the referenced value's type when the
  whole string is one interpolation, string-substituted otherwise.
- ``${env:VAR}`` / ``${env:VAR,default}``: environment-variable resolver.
- ``to_yaml(resolve=True)`` / ``to_dict(resolve=True)``: fully-resolved
  dumps; saving a config keeps interpolations intact, like ``OmegaConf.save``.

``as_config`` accepts ``Config | dict | None`` the way the reference pipeline
accepts ``OmegaConf | dict | None``, and transparently converts OmegaConf
objects if the user passes one (duck-typed via ``to_container``).
"""

from __future__ import annotations

import copy
import os
import re
from pathlib import Path
from typing import Any, Iterator, Mapping

import yaml

_INTERP = re.compile(r"\$\{([^${}]+)\}")


class InterpolationError(ValueError):
    pass


def _needs_resolution(value: Any) -> bool:
    if isinstance(value, str):
        return "${" in value
    if isinstance(value, (list, tuple)):
        return any(_needs_resolution(v) for v in value)
    if isinstance(value, dict):
        return any(_needs_resolution(v) for v in value.values())
    return False


def _resolve_ref(expr: str, root: "Config", active: frozenset) -> Any:
    expr = expr.strip()
    if expr.startswith("env:"):
        name, sep, default = expr[4:].partition(",")
        value = os.environ.get(name.strip())
        if value is not None:
            return value
        if sep:
            return default.strip()
        raise InterpolationError(f"environment variable {name.strip()!r} is not set and has no default")
    if expr in active:
        raise InterpolationError(f"interpolation cycle through ${{{expr}}}")
    active = active | {expr}
    node: Any = root
    for part in expr.split("."):
        if isinstance(node, str) and "${" in node:
            # an intermediate segment may itself be an alias ("${alias.lr}"
            # where alias = "${model}") — resolve before indexing into it
            node = _resolve_value(node, root, active)
        try:
            node = node._data[part] if isinstance(node, Config) else node[part]
        except (KeyError, TypeError, IndexError):
            raise InterpolationError(f"interpolation ${{{expr}}} does not resolve to a key") from None
    return _resolve_value(node, root, active)


def _substitute(match: "re.Match", root: "Config", active: frozenset) -> str:
    value = _resolve_ref(match.group(1), root, active)
    if isinstance(value, (Config, dict, list, tuple)):
        raise InterpolationError(
            f"cannot substitute ${{{match.group(1).strip()}}} into a string: "
            f"it resolves to a {type(value).__name__} node, not a scalar"
        )
    return str(value)


def _resolve_value(value: Any, root: "Config", active: frozenset = frozenset()) -> Any:
    """Resolve interpolations in a raw value, recursing into lists/tuples and
    plain dicts. A string that is exactly one ``${...}`` keeps the referenced
    value's type; embedded occurrences are substituted as strings (scalar
    targets only). Values with no interpolation anywhere are returned AS
    STORED — container reads stay live objects that callers may mutate."""
    if not _needs_resolution(value):
        return value
    if isinstance(value, str):
        whole = _INTERP.fullmatch(value.strip())
        if whole:
            return _resolve_ref(whole.group(1), root, active)
        return _INTERP.sub(lambda m: _substitute(m, root, active), value)
    if isinstance(value, (list, tuple)):
        return type(value)(_resolve_value(v, root, active) for v in value)
    if isinstance(value, dict):
        return {k: _resolve_value(v, root, active) for k, v in value.items()}
    return value


def _plainify(value: Any) -> Any:
    """Convert any Config nodes a resolution produced (e.g. a whole-string
    ``${model}`` alias to a mapping node) into plain dicts for serialisation."""
    if isinstance(value, Config):
        return value.to_dict(resolve=True)
    if isinstance(value, (list, tuple)):
        return type(value)(_plainify(v) for v in value)
    if isinstance(value, dict):
        return {k: _plainify(v) for k, v in value.items()}
    return value


class Config(Mapping):
    """Nested dict with attribute access: ``cfg.model.lr`` == ``cfg['model']['lr']``.
    Values read through any access path have their ``${...}`` interpolations
    resolved against the root config."""

    def __init__(self, data: Mapping | None = None):
        object.__setattr__(self, "_data", {})
        object.__setattr__(self, "_parent", None)
        if data:
            # read RAW items when copying a Config — going through its
            # resolving __getitem__ would eagerly materialise (or raise on)
            # interpolations that should be copied verbatim
            items = data._data.items() if isinstance(data, Config) else dict(data).items()
            for k, v in items:
                self[k] = v

    def _root(self) -> "Config":
        node = self
        while node._parent is not None:
            node = node._parent
        return node

    # -- mapping protocol ---------------------------------------------------
    def __getitem__(self, key: str) -> Any:
        return _resolve_value(self._data[key], self._root())

    def __setitem__(self, key: str, value: Any) -> None:
        if isinstance(value, Config):
            # copy by value (OmegaConf node-assignment semantics): re-parenting
            # the original object would silently detach it from ITS tree and
            # break every ${...} in the source config
            value = Config(value)
        elif isinstance(value, Mapping):
            value = Config(value)
        elif isinstance(value, (list, tuple)):
            # lists are stored by value too — reads return the stored object
            # live (mutation persists), so sharing it across configs would
            # let a "copy" mutate its source
            value = copy.deepcopy(value)
        if isinstance(value, Config):
            object.__setattr__(value, "_parent", self)
        self._data[key] = value

    def __delitem__(self, key: str) -> None:
        del self._data[key]

    def __iter__(self) -> Iterator[str]:
        return iter(self._data)

    def __len__(self) -> int:
        return len(self._data)

    def __contains__(self, key: object) -> bool:
        return key in self._data

    # -- attribute access ---------------------------------------------------
    def __getattr__(self, key: str) -> Any:
        try:
            return self[key]
        except KeyError:
            raise AttributeError(key) from None

    def __setattr__(self, key: str, value: Any) -> None:
        self[key] = value

    def get(self, key: str, default: Any = None) -> Any:
        if key not in self._data:
            return default
        return self[key]

    def setdefault(self, key: str, default: Any = None) -> Any:
        if key not in self._data:
            self[key] = default
        return self[key]

    def update(self, other: Mapping) -> None:
        items = other._data.items() if isinstance(other, Config) else dict(other).items()
        for k, v in items:
            self[k] = v

    # -- conversion ---------------------------------------------------------
    def to_dict(self, resolve: bool = False) -> dict:
        out = {}
        for k, raw in self._data.items():
            if isinstance(raw, Config):
                out[k] = raw.to_dict(resolve=resolve)
            elif resolve:
                out[k] = _plainify(_resolve_value(raw, self._root()))
            else:
                out[k] = raw
        return out

    def resolve(self) -> "Config":
        """A new Config with every interpolation materialised (raises
        ``InterpolationError`` on dangling references or cycles)."""
        return Config(self.to_dict(resolve=True))

    def to_yaml(self, resolve: bool = False) -> str:
        return yaml.safe_dump(self.to_dict(resolve=resolve), sort_keys=False)

    def save(self, path: str | Path) -> None:
        """Write YAML with interpolations INTACT (like ``OmegaConf.save``) —
        a reloaded config keeps resolving against its current context."""
        _as_epath(path).write_text(self.to_yaml())

    @classmethod
    def load(cls, path: str | Path) -> "Config":
        data = yaml.safe_load(_as_epath(path).read_text())
        return cls(data or {})

    def __repr__(self) -> str:
        return f"Config({self.to_dict()!r})"


def _as_epath(path):
    """Local path coercion (the port has no object-store paths yet)."""
    return Path(path)


def as_config(obj: Any) -> Config:
    """Coerce ``Config | dict | OmegaConf | None`` to a Config."""
    if obj is None:
        return Config()
    if isinstance(obj, Config):
        return obj
    if isinstance(obj, Mapping):
        return Config(obj)
    # OmegaConf duck-typing without importing omegaconf.
    if hasattr(obj, "_content") or type(obj).__name__ in ("DictConfig",):
        try:
            from omegaconf import OmegaConf  # type: ignore

            return Config(OmegaConf.to_container(obj, resolve=True))
        except Exception:
            pass
    raise TypeError(f"cannot convert {type(obj)!r} to Config")
