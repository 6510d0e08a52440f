"""Carry weights from the JAX package's param trees to the port's state_dicts.

A JAX param tree is given as nested dicts of numpy arrays (the ``params``
collection, e.g. ``jax.tree_util.tree_map(np.asarray, variables["params"])``).
flax ``Dense`` kernels are [in, out] and become ``Linear`` weights [out, in];
``LayerNorm`` ``scale`` becomes ``weight``; ``Embed`` ``embedding`` becomes
``weight``; ``layer_i`` becomes ``layers.i``. GRU4Rec's ``GRUStack`` cells
``gru/cell_k_wi/kernel`` [Din, 3H] and ``gru/cell_k/wh/kernel`` [H, 3H]
become ``nn.GRU``'s ``gru.weight_ih_lk`` [3H, Din] and ``gru.weight_hh_lk``
[3H, H] (both gate orders are r, z, n); FMLP's filter keeps its
``complex_weight`` as it is, and its auto-named ``LayerNorm_0`` becomes
``norm``. GNN's ``backbone/...`` becomes ``backbone....`` (the same
encoder rules), the VQ layers' ``level_i/codebook`` stays ``level_i.codebook``.
An item table with more rows than the module's (padded to a multiple of the
``model`` axis by an EP run, ``dr4sr_tpu/parallel/ep.py::padded_rows``) keeps
its first rows. Every leaf of the JAX tree must be used, and the result must
hold exactly the module's keys at its shapes, or the conversion raises.
"""

from __future__ import annotations

import re
from typing import Any, Dict, Mapping, Tuple

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


_GRU_KERNEL = re.compile(r"^gru/cell_(\d+)(_wi|/wh)/kernel$")


def _rename(jax_key: str) -> str:
    """``encoder/layer_0/qkv/kernel`` -> ``encoder.layers.0.qkv.weight``;
    ``gru/cell_1/wh/kernel`` -> ``gru.weight_hh_l1``."""
    gru = _GRU_KERNEL.match(jax_key)
    if gru:
        return f"gru.weight_{'ih' if gru.group(2) == '_wi' else 'hh'}_l{gru.group(1)}"
    parts = jax_key.split("/")
    leaf = {"kernel": "weight", "scale": "weight", "embedding": "weight"}.get(parts[-1], parts[-1])
    names = [f"layers.{p[len('layer_'):]}" if p.startswith("layer_")
             else "norm" if p == "LayerNorm_0" else p for p in parts[:-1]]
    return ".".join(names + [leaf])


def params_from_jax(params: Mapping[str, Any], module: nn.Module) -> Dict[str, torch.Tensor]:
    """``module``'s state_dict from the JAX params of the same architecture
    (any registered model, the regenerator, or a sub-module of either), by
    the rules above."""
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
        if name.endswith("item_embedding.weight") and tensor.shape[0] > expected[name].shape[0]:
            # a table padded for a row-sharded (EP) run: no id reaches the padding
            tensor = tensor[: expected[name].shape[0]].clone()
        if tensor.shape != expected[name].shape:
            raise ValueError(f"{jax_key!r}: shape {tuple(tensor.shape)} != {tuple(expected[name].shape)}")
        out[name] = tensor
    missing = sorted(set(expected) - set(out))
    if missing:
        raise ValueError(f"module keys with no JAX param: {missing}")
    return out


def sasrec_params_from_jax(params: Mapping[str, Any], module: nn.Module) -> Dict[str, torch.Tensor]:
    """``module``'s state_dict from the JAX params of the same architecture.

    For ``SASRecEncoder``: item/position embeddings copy as they are, each
    encoder layer's ``qkv``/``out_proj``/``ffn1``/``ffn2`` kernel is
    transposed, and ``norm1``/``norm2`` scale/bias become LayerNorm
    weight/bias. A sub-tree converts the same way into its sub-module (the
    ``encoder`` params into a ``TransformerEncoder``)."""
    return params_from_jax(params, module)


def generator_params_from_jax(params: Mapping[str, Any], module: nn.Module) -> Dict[str, torch.Tensor]:
    """The regenerator's state_dict (``regen.generator.Generator``, or one of
    its sub-modules: a ``TransformerDecoder``, an ``MLP``) from the JAX
    params, by the same rules: ``decoder/layer_i/{self_qkv, self_out,
    cross_q, cross_kv, cross_out, ffn1, ffn2}`` kernels transposed,
    ``norm1..3`` scale → weight, ``condition_linear/dense_i`` and
    ``condition_encoder/condition_layer/dense_i`` transposed, embeddings
    as they are."""
    return params_from_jax(params, module)


def meta_params_from_jax(meta_params: Mapping[str, Any],
                         module: nn.Module) -> Tuple[Dict[str, torch.Tensor], float]:
    """The bilevel trainer's meta parameters from the JAX ``MetaTrainer``'s
    ``{"mlp": {dense_i: {kernel, bias}}, "tau": ()}``: the meta MLP's
    state_dict (``module``, a ``modules.layers.MLP``; kernels transposed)
    and τ as a float."""
    return params_from_jax(meta_params["mlp"], module), float(np.asarray(meta_params["tau"]))
