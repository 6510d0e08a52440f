"""Layered YAML configuration (the port's own copy of ``dr4sr_tpu/config.py``).

A config is a dict of four sections ``{data, model, train, eval}`` assembled
from three YAML layers:

    1. ``configs/<dataset>.yaml``   -> becomes the ``data`` section
    2. ``configs/basemodel.yaml``   -> provides ``train``/``model``/``eval``
    3. ``configs/<model>.yaml``     -> per-section *update* (override/extend)

``yaml`` is imported only when a file is read, so code that builds its
config in Python (``chip_smoke.py``) needs no PyYAML.
"""

from __future__ import annotations

import copy
import os
from typing import Any, Dict, Optional

# Default location of the bundled config files: <repo>/configs
_DEFAULT_CONFIG_DIR = os.path.join(
    os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "configs"
)

Config = Dict[str, Dict[str, Any]]


def _read_yaml(path: str) -> Dict[str, Any]:
    import yaml

    with open(path, "r") as stream:
        out = yaml.safe_load(stream)
    return out or {}


def load_config(
    model: str,
    dataset: str,
    config_dir: Optional[str] = None,
    overrides: Optional[Dict[str, Dict[str, Any]]] = None,
) -> Config:
    """Build the layered config for (model, dataset).

    ``overrides`` is an optional ``{section: {key: value}}`` dict applied last.
    """
    config_dir = config_dir or _DEFAULT_CONFIG_DIR

    config: Config = {}
    # layer 1: dataset yaml -> data section
    config["data"] = _read_yaml(os.path.join(config_dir, dataset.lower() + ".yaml"))
    config["data"]["dataset"] = dataset

    # layer 2: basemodel yaml -> train/model/eval sections
    base = _read_yaml(os.path.join(config_dir, "basemodel.yaml"))
    for key, value in base.items():
        config[key] = copy.deepcopy(value)

    # layer 3: model yaml -> per-section update
    model_path = os.path.join(config_dir, model.lower() + ".yaml")
    if os.path.exists(model_path):
        for key, value in _read_yaml(model_path).items():
            config.setdefault(key, {}).update(value)

    config["model"]["model"] = model

    if overrides:
        for section, kv in overrides.items():
            config.setdefault(section, {}).update(kv)
    return config


def flatten_config(config: Config) -> Dict[str, Any]:
    """Flatten to ``section.key`` -> value (sweep-config convention)."""
    flat = {}
    for section, kv in config.items():
        if isinstance(kv, dict):
            for k, v in kv.items():
                flat[f"{section}.{k}"] = v
        else:
            flat[section] = kv
    return flat


def unflatten_config(flat: Dict[str, Any]) -> Config:
    """Inverse of :func:`flatten_config`."""
    config: Config = {"data": {}, "model": {}, "train": {}, "eval": {}}
    for k, v in flat.items():
        section, _, key = k.partition(".")
        config.setdefault(section, {})[key] = v
    return config
