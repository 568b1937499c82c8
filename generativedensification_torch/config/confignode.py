"""A minimal OmegaConf-compatible config tree.

The reference drives everything through OmegaConf YAML files plus dotted CLI
overrides (``train_lightning.py:100-107``, ``evaluation.py:231-239``).
OmegaConf is not available in this environment, so this module provides the
subset the config surface needs:

  * attribute + item access over nested dicts,
  * deep merge (later wins),
  * dotted CLI overrides (``a.b.c=value``, values YAML-parsed),
  * ``${path.to.key}`` interpolation resolved lazily at access time,
  * YAML load/save (PyYAML is imported where a YAML file or override is
    parsed, so the rest of the port runs without it).

Copy of ``generativedensification_tpu/config/confignode.py``: the PyTorch
port imports nothing of the JAX package.

The public config files keep the exact schema of ``configs/base.yaml`` /
``configs/infer.yaml`` so reference users can bring their configs unchanged.
"""

from __future__ import annotations

import copy
import re
from typing import Any, Iterator, Mapping

_INTERP_RE = re.compile(r"^\$\{([^}]+)\}$")
_INTERP_SUB_RE = re.compile(r"\$\{([^}]+)\}")


class ConfigNode(Mapping):
    """Nested dict with attribute access and ${...} interpolation."""

    def __init__(self, data: dict | None = None, root: "ConfigNode | None" = None):
        object.__setattr__(self, "_data", {})
        object.__setattr__(self, "_root", root)
        if data:
            for k, v in data.items():
                self[k] = v

    # -- core access ---------------------------------------------------------

    def _wrap(self, value: Any) -> Any:
        if isinstance(value, ConfigNode):
            object.__setattr__(value, "_root", self._root_node())
            return value
        if isinstance(value, Mapping):
            return ConfigNode(dict(value), root=self._root_node())
        return value

    def _root_node(self) -> "ConfigNode":
        return self._root if self._root is not None else self

    def _resolve(self, value: Any) -> Any:
        if isinstance(value, str):
            m = _INTERP_RE.match(value)
            if m:
                return self._root_node().select(m.group(1))
            if "${" in value:
                return _INTERP_SUB_RE.sub(
                    lambda mm: str(self._root_node().select(mm.group(1))), value
                )
        return value

    def __getitem__(self, key: str) -> Any:
        return self._resolve(self._data[key])

    def __setitem__(self, key: str, value: Any) -> None:
        self._data[key] = self._wrap(value)

    def __getattr__(self, key: str) -> Any:
        if key.startswith("_"):
            raise AttributeError(key)
        try:
            return self[key]
        except KeyError as e:
            raise AttributeError(f"config key not found: {key}") from e

    def __setattr__(self, key: str, value: Any) -> None:
        self[key] = value

    def __contains__(self, key) -> bool:
        return key in self._data

    def __iter__(self) -> Iterator[str]:
        return iter(self._data)

    def __len__(self) -> int:
        return len(self._data)

    def get(self, key: str, default: Any = None) -> Any:
        try:
            return self[key]
        except KeyError:
            return default

    def keys(self):
        return self._data.keys()

    def items(self):
        return ((k, self[k]) for k in self._data)

    def select(self, dotted: str, default: Any = ...) -> Any:
        """Fetch ``a.b.c``; raises KeyError unless a default is given."""
        node: Any = self
        for part in dotted.split("."):
            try:
                node = node[part]
            except (KeyError, TypeError):
                if default is ...:
                    raise KeyError(dotted)
                return default
        return node

    def set_dotted(self, dotted: str, value: Any) -> None:
        parts = dotted.split(".")
        node = self
        for p in parts[:-1]:
            if p not in node or not isinstance(node._data.get(p), ConfigNode):
                node[p] = ConfigNode(root=self._root_node())
            node = node._data[p]
        node[parts[-1]] = value

    def __repr__(self) -> str:
        return f"ConfigNode({to_dict(self)!r})"

    def __deepcopy__(self, memo):
        return ConfigNode(copy.deepcopy(to_dict(self), memo))


def to_dict(node: Any, resolve: bool = False) -> Any:
    """ConfigNode tree -> plain dict (optionally resolving interpolations)."""
    if isinstance(node, ConfigNode):
        if resolve:
            return {k: to_dict(node[k], True) for k in node._data}
        return {k: to_dict(v, False) for k, v in node._data.items()}
    if isinstance(node, list):
        return [to_dict(v, resolve) for v in node]
    return node


def load_yaml(path: str) -> ConfigNode:
    import yaml

    with open(path) as f:
        data = yaml.safe_load(f) or {}
    return ConfigNode(data)


def merge(*nodes: ConfigNode | dict) -> ConfigNode:
    """Deep merge; later arguments override earlier ones (OmegaConf.merge)."""
    out = ConfigNode()

    def _merge_into(dst: ConfigNode, src: Mapping):
        for k in src.keys():
            sv = src._data[k] if isinstance(src, ConfigNode) else src[k]
            if (
                k in dst
                and isinstance(dst._data.get(k), ConfigNode)
                and isinstance(sv, Mapping)
            ):
                _merge_into(dst._data[k], sv if isinstance(sv, ConfigNode) else ConfigNode(dict(sv)))
            else:
                dst[k] = copy.deepcopy(to_dict(sv)) if isinstance(sv, Mapping) else copy.deepcopy(sv)

    for n in nodes:
        if n is None:
            continue
        _merge_into(out, n if isinstance(n, Mapping) else ConfigNode(dict(n)))
    return out


def from_dotlist(args: list[str]) -> ConfigNode:
    """Parse CLI overrides like ``train.lr=1e-4 model.k_num=8000``."""
    import yaml

    out = ConfigNode()
    for arg in args:
        if "=" not in arg:
            raise ValueError(f"override must be key=value, got: {arg}")
        key, raw = arg.split("=", 1)
        value = yaml.safe_load(raw)
        if isinstance(value, str):
            # YAML 1.1 misses bare scientific notation ("1e-5"); coerce.
            try:
                value = int(value)
            except ValueError:
                try:
                    value = float(value)
                except ValueError:
                    pass
        out.set_dotted(key.strip(), value)
    return out


def save_yaml(node: ConfigNode, path: str) -> None:
    import yaml

    with open(path, "w") as f:
        yaml.safe_dump(to_dict(node), f, sort_keys=False)
