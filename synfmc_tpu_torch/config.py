"""Reference-format YAML configs (configs/cam.yaml, configs/obj.yaml) as
plain dicts, and the placeholder test of their checkpoint paths.

The same YAML keys as synfmc_tpu/config.py; the port reads them as a plain
dict (no attribute access): ``get_path`` reads a dotted key,
``save_config`` echoes a config into a run directory.
"""

from __future__ import annotations

from typing import Any, Mapping

import yaml


def load_config(config) -> dict:
    """A config dict (returned as it is), or the path of a YAML file."""
    if isinstance(config, dict):
        return config
    with open(config) as fh:
        return yaml.safe_load(fh) or {}


def is_placeholder_path(p) -> bool:
    """True for the shipped configs' '[path to ...]' placeholder strings:
    explicitly not a path, skipped quietly everywhere (unlike a mistyped real
    path, which is reported)."""
    return str(p).strip().startswith("[")


def get_path(config: Mapping, dotted: str, default=None):
    """``get_path(cfg, "train_data.params.sample_size")``: the value under a
    dotted key, or ``default`` where a part is missing."""
    node: Any = config
    for part in dotted.split("."):
        if not isinstance(node, Mapping) or part not in node:
            return default
        node = node[part]
    return node


def save_config(config: Mapping, path: str) -> None:
    """Echo the full config to the run dir (reference: train_cam_ctrl.py:218)."""
    with open(path, "w") as f:
        yaml.safe_dump(_plain(config), f, sort_keys=False)


def _plain(value):
    if isinstance(value, Mapping):
        return {k: _plain(v) for k, v in value.items()}
    if isinstance(value, (list, tuple)):
        return [_plain(v) for v in value]
    return value
