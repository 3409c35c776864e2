"""Reference-format YAML configs (configs/cam.yaml, configs/obj.yaml) as
plain dicts, and the placeholder test of their checkpoint paths.

The same YAML keys as synfmc_tpu/config.py; the port reads them as a plain
dict (no attribute access).
"""

from __future__ import annotations

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
