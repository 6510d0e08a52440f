"""Checkpoints: the port's own format, and a reader for the JAX package's.

* :func:`save_checkpoint` / :func:`load_checkpoint` — ``torch.save`` of
  ``{config, model, epoch, parameters, metric}``, the reference's own
  ``.ckpt`` layout (``utils/callbacks.py:70-85``), ``parameters`` being the
  module's state_dict on the CPU; plus the ``<path>.json`` sidecar
  ``{config, model, epoch, metric}`` that the JAX package also writes.
* :func:`load_jax_checkpoint` — the params of a checkpoint written by
  ``dr4sr_tpu/train/checkpoint.py::save_checkpoint`` (flax msgpack), as a
  tree of dicts of numpy arrays for ``convert.sasrec_params_from_jax``. It
  needs no msgpack package: :func:`msgpack_decode` reads the subset flax
  writes — maps, arrays, str, bin, ints, floats, bool, nil, and the ext
  types 1 (ndarray) and 3 (numpy scalar), each ``(shape, dtype name, bytes)``,
  and 2 (complex) — and undoes flax's chunking of arrays above 1 GiB.
* :func:`save_regenerator` / :func:`load_regenerator` — the regenerator's
  state_dict with its widths; the loader also takes a JAX regenerator
  msgpack (``scripts/pretrain_regenerator.py``'s output).
* :func:`load_item_embedding` — the item table that seeds the regenerator
  (``--embedding``): from a JAX msgpack or a ``torch.save`` checkpoint,
  this package's or the reference's.
"""

from __future__ import annotations

import json
import os
import struct
from typing import Any, Dict, Mapping, Optional, Tuple

import numpy as np
import torch

from dr4sr_tpu_torch.convert import generator_params_from_jax
from dr4sr_tpu_torch.regen.generator import Generator
from dr4sr_tpu_torch.regen.pipeline import torch_device
from dr4sr_tpu_torch.serialization import load_with_numpy


def _write_sidecar(path: str, config, model_name: str, epoch: int, metric) -> None:
    meta = {
        "config": config,
        "model": model_name,
        "epoch": int(epoch),
        "metric": {k: float(v) for k, v in metric.items()},
    }
    with open(path + ".json", "w") as f:
        json.dump(meta, f, indent=1, default=str)


def save_checkpoint(
    path: str,
    params: Mapping[str, torch.Tensor],
    config: Dict[str, Any],
    model_name: str,
    epoch: int,
    metric: Dict[str, float],
) -> None:
    """Write ``params`` (a state_dict) and the metadata to ``path``."""
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    payload = {
        "config": config,
        "model": model_name,
        "epoch": int(epoch),
        "parameters": {k: v.detach().cpu() for k, v in params.items()},
        "metric": {k: float(v) for k, v in metric.items()},
    }
    torch.save(payload, path)
    _write_sidecar(path, config, model_name, epoch, metric)


def load_checkpoint(path: str) -> Tuple[Dict[str, torch.Tensor], Dict[str, Any]]:
    """(state_dict on the CPU, metadata) of a checkpoint of this package."""
    payload = torch.load(path, map_location="cpu", weights_only=True)
    meta = {k: payload[k] for k in ("config", "model", "epoch", "metric")}
    return payload["parameters"], meta


def is_jax_checkpoint(path: str) -> bool:
    """A flax msgpack file starts with a map; ``torch.save`` writes a zip."""
    with open(path, "rb") as f:
        head = f.read(1)
    return bool(head) and (0x80 <= head[0] <= 0x8F or head[0] in (0xDE, 0xDF))


# --------------------------------------------------------------------- msgpack

_FIXED = {  # first byte -> (struct format, size)
    0xCA: (">f", 4), 0xCB: (">d", 8),
    0xCC: (">B", 1), 0xCD: (">H", 2), 0xCE: (">I", 4), 0xCF: (">Q", 8),
    0xD0: (">b", 1), 0xD1: (">h", 2), 0xD2: (">i", 4), 0xD3: (">q", 8),
}
_LEN = {1: ">B", 2: ">H", 4: ">I"}


def _ndarray(data: bytes) -> np.ndarray:
    shape, dtype_name, buf = msgpack_decode(data)
    if dtype_name == "bfloat16":  # numpy has no bfloat16: widen to float32
        bits = np.frombuffer(buf, np.uint16).astype(np.uint32) << 16
        return bits.view(np.float32).reshape(shape)
    return np.frombuffer(buf, dtype=np.dtype(dtype_name)).reshape(shape)


def _ext(code: int, data: bytes):
    if code == 1:
        return _ndarray(data)
    if code == 2:
        real, imag = msgpack_decode(data)
        return complex(real, imag)
    if code == 3:
        return _ndarray(data)[()]
    raise ValueError(f"msgpack ext type {code} is not one flax writes")


class _Reader:
    def __init__(self, data: bytes) -> None:
        self.data = data
        self.pos = 0

    def take(self, n: int) -> bytes:
        if self.pos + n > len(self.data):
            raise ValueError("truncated msgpack data")
        out = self.data[self.pos : self.pos + n]
        self.pos += n
        return out

    def uint(self, size: int) -> int:
        return struct.unpack(_LEN[size], self.take(size))[0]

    def value(self):
        b = self.take(1)[0]
        if b <= 0x7F:
            return b
        if b >= 0xE0:
            return b - 0x100
        if 0x80 <= b <= 0x8F:
            return self.map(b & 0x0F)
        if 0x90 <= b <= 0x9F:
            return self.array(b & 0x0F)
        if 0xA0 <= b <= 0xBF:
            return self.take(b & 0x1F).decode("utf-8")
        if b == 0xC0:
            return None
        if b in (0xC2, 0xC3):
            return b == 0xC3
        if b in _FIXED:
            fmt, size = _FIXED[b]
            return struct.unpack(fmt, self.take(size))[0]
        if b in (0xC4, 0xC5, 0xC6):  # bin 8/16/32
            return self.take(self.uint({0xC4: 1, 0xC5: 2, 0xC6: 4}[b]))
        if b in (0xD9, 0xDA, 0xDB):  # str 8/16/32
            return self.take(self.uint({0xD9: 1, 0xDA: 2, 0xDB: 4}[b])).decode("utf-8")
        if b in (0xDC, 0xDD):  # array 16/32
            return self.array(self.uint(2 if b == 0xDC else 4))
        if b in (0xDE, 0xDF):  # map 16/32
            return self.map(self.uint(2 if b == 0xDE else 4))
        if 0xD4 <= b <= 0xD8:  # fixext 1/2/4/8/16
            code = struct.unpack(">b", self.take(1))[0]
            return _ext(code, self.take(1 << (b - 0xD4)))
        if b in (0xC7, 0xC8, 0xC9):  # ext 8/16/32
            n = self.uint({0xC7: 1, 0xC8: 2, 0xC9: 4}[b])
            code = struct.unpack(">b", self.take(1))[0]
            return _ext(code, self.take(n))
        raise ValueError(f"msgpack byte 0x{b:02x} at {self.pos - 1} is not one flax writes")

    def array(self, n: int):
        return [self.value() for _ in range(n)]

    def map(self, n: int):
        out = {}
        for _ in range(n):
            key = self.value()
            out[key] = self.value()
        return out


def _unchunk(node):
    """Undo flax's ``_chunk`` of arrays above its 1 GiB leaf limit."""
    if not isinstance(node, dict):
        return node
    if "__msgpack_chunked_array__" in node:
        shape = tuple(node["shape"][str(i)] for i in range(len(node["shape"])))
        chunks = [node["chunks"][str(i)] for i in range(len(node["chunks"]))]
        return np.concatenate(chunks).reshape(shape)
    return {k: _unchunk(v) for k, v in node.items()}


def msgpack_decode(data: bytes):
    """One msgpack value from ``data``, which it must use up exactly."""
    reader = _Reader(data)
    out = reader.value()
    if reader.pos != len(data):
        raise ValueError(f"{len(data) - reader.pos} trailing bytes after the msgpack value")
    return out


def load_jax_checkpoint(path: str) -> Dict[str, Any]:
    """The param tree (nested dicts of numpy arrays) of a JAX checkpoint."""
    with open(path, "rb") as f:
        return _unchunk(msgpack_decode(f.read()))


def _find_item_table(node) -> Optional[np.ndarray]:
    """The first ``item_embedding/embedding`` of a JAX param tree."""
    if not isinstance(node, dict):
        return None
    emb = node.get("item_embedding")
    if isinstance(emb, dict) and "embedding" in emb:
        return np.asarray(emb["embedding"], np.float32)
    for value in node.values():
        found = _find_item_table(value)
        if found is not None:
            return found
    return None


def load_item_embedding(path: str) -> Optional[np.ndarray]:
    """The item table [rows, D] of a checkpoint, to seed the regenerator
    (``--embedding``): a JAX msgpack (its ``item_embedding/embedding``), or
    a ``torch.save`` file whose ``parameters`` (or the file itself) hold
    ``item_embedding.weight`` — this package's checkpoints and the
    reference's ``.ckpt``, loaded with ``weights_only=True`` and numpy's
    classes allowed (``serialization.load_with_numpy``). None if the file
    has no item table."""
    if is_jax_checkpoint(path):
        return _find_item_table(load_jax_checkpoint(path))
    saved = load_with_numpy(path, map_location="cpu")
    params = saved.get("parameters", saved)
    for key in ("item_embedding.weight", "item_embedding"):
        if key in params:
            return params[key].detach().float().numpy()
    return None


def save_regenerator(path: str, module) -> None:
    """``torch.save`` of the regenerator's state_dict (on the CPU) and the
    widths that rebuild it (``Generator.widths``)."""
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    torch.save({"model": "Generator", "widths": module.widths(),
                "parameters": {k: v.detach().cpu() for k, v in module.state_dict().items()}},
               path)


def load_regenerator(path: str, device="cuda"):
    """A ``regen.generator.Generator`` in eval mode on ``device`` (the card
    unless the caller asks for the CPU; raises without CUDA), from a
    checkpoint of :func:`save_regenerator` or a JAX regenerator msgpack
    (``{"params": ...}``, widths read from the shapes; the head count is not
    in them, and the JAX pipeline always builds 2 heads)."""
    if is_jax_checkpoint(path):
        params = load_jax_checkpoint(path)["params"]
        emb = params["item_embedding"]["embedding"]
        widths = {
            "num_items": emb.shape[0] - 2,
            "k": params["condition_encoder"]["condition_layer"]["dense_1"]["kernel"].shape[1],
            "embed_dim": emb.shape[1],
            "num_heads": 2,
            "num_layers": sum(1 for key in params["encoder"] if key.startswith("layer_")),
            "ffn_dim": params["encoder"]["layer_0"]["ffn1"]["kernel"].shape[1],
            "max_len": params["position_embedding"]["embedding"].shape[0],
        }
        module = Generator(**widths)
        module.load_state_dict(generator_params_from_jax(params, module))
    else:
        payload = torch.load(path, map_location="cpu", weights_only=True)
        if payload.get("model") != "Generator":
            raise ValueError(f"{path} is not a regenerator checkpoint")
        module = Generator(**payload["widths"])
        module.load_state_dict(payload["parameters"])
    return module.to(torch_device(device)).eval()


def read_sidecar(path: str) -> Dict[str, Any]:
    """The ``<path>.json`` metadata both packages write, or {} if absent."""
    if not os.path.exists(path + ".json"):
        return {}
    with open(path + ".json") as f:
        return json.load(f)
