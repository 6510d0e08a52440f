"""Carry weights from the JAX package's param trees to the port's state_dicts.

A JAX param tree is given as nested dicts of numpy arrays (the ``params``
collection, e.g. ``jax.tree_util.tree_map(np.asarray, variables["params"])``).
flax ``Dense`` kernels are [in, out] and become ``Linear`` weights [out, in];
``LayerNorm`` ``scale`` becomes ``weight``; ``Embed`` ``embedding`` becomes
``weight``. Every leaf of the JAX tree must be used, and the result must
hold exactly the module's keys at its shapes, or the conversion raises.
"""

from __future__ import annotations

from typing import Any, Dict, Mapping

import numpy as np
import torch
from torch import nn


def _flatten(tree: Mapping[str, Any], prefix: str = "") -> Dict[str, np.ndarray]:
    out = {}
    for key, value in tree.items():
        path = f"{prefix}{key}"
        if isinstance(value, Mapping):
            out.update(_flatten(value, path + "/"))
        else:
            out[path] = np.asarray(value)
    return out


def _rename(jax_key: str) -> str:
    """``encoder/layer_0/qkv/kernel`` -> ``encoder.layers.0.qkv.weight``."""
    parts = jax_key.split("/")
    leaf = {"kernel": "weight", "scale": "weight", "embedding": "weight"}.get(parts[-1], parts[-1])
    names = [f"layers.{p[len('layer_'):]}" if p.startswith("layer_") else p for p in parts[:-1]]
    return ".".join(names + [leaf])


def sasrec_params_from_jax(params: Mapping[str, Any], module: nn.Module) -> Dict[str, torch.Tensor]:
    """``module``'s state_dict from the JAX params of the same architecture.

    For ``SASRecEncoder``: item/position embeddings copy as they are, each
    encoder layer's ``qkv``/``out_proj``/``ffn1``/``ffn2`` kernel is
    transposed, and ``norm1``/``norm2`` scale/bias become LayerNorm
    weight/bias. A sub-tree converts the same way into its sub-module (the
    ``encoder`` params into a ``TransformerEncoder``)."""
    flat = _flatten(params)
    expected = module.state_dict()
    out: Dict[str, torch.Tensor] = {}
    for jax_key, value in flat.items():
        name = _rename(jax_key)
        if name not in expected:
            raise ValueError(f"JAX param {jax_key!r} has no counterpart {name!r} in the module")
        if jax_key.endswith("/kernel"):
            value = value.T
        tensor = torch.from_numpy(np.array(value, dtype=np.float32, order="C"))  # a copy
        if tensor.shape != expected[name].shape:
            raise ValueError(f"{jax_key!r}: shape {tuple(tensor.shape)} != {tuple(expected[name].shape)}")
        out[name] = tensor
    missing = sorted(set(expected) - set(out))
    if missing:
        raise ValueError(f"module keys with no JAX param: {missing}")
    return out
