"""Plain PyTorch building blocks of the references: attention, the post-norm
layers, and the weights drawn in the order the port draws them.

Float32 throughout. :func:`precision` sets TF32 off (the configurations'
f32) or on (the control's lower precision) for every matrix product inside
it. Nothing here imports the port or JAX.
"""

from __future__ import annotations

import contextlib
from typing import Dict, List, Optional

import torch
import torch.nn.functional as F

NEG = -1e30


@contextlib.contextmanager
def precision(tf32: bool):
    """Float32 products in full f32 (``tf32=False``) or in TF32 inside the body."""
    prev = (torch.get_float32_matmul_precision(), torch.backends.cuda.matmul.allow_tf32,
            torch.backends.cudnn.allow_tf32)
    torch.set_float32_matmul_precision("high" if tf32 else "highest")
    torch.backends.cuda.matmul.allow_tf32 = tf32
    torch.backends.cudnn.allow_tf32 = tf32
    try:
        yield
    finally:
        torch.set_float32_matmul_precision(prev[0])
        torch.backends.cuda.matmul.allow_tf32 = prev[1]
        torch.backends.cudnn.allow_tf32 = prev[2]


class Draws:
    """normal(0, 0.02) weights from one CPU generator seeded ``seed``, drawn
    tensor by tensor in the order of the calls (the port's ``normal_init``
    order), collected by name."""

    def __init__(self, seed: int) -> None:
        self.gen = torch.Generator().manual_seed(seed)
        self.params: Dict[str, torch.Tensor] = {}

    def normal(self, name: str, *shape: int) -> torch.Tensor:
        t = torch.empty(*shape).normal_(0.0, 0.02, generator=self.gen)
        self.params[name] = t
        return t

    def fixed(self, name: str, value: float, *shape: int) -> torch.Tensor:
        t = torch.full(shape, value)
        self.params[name] = t
        return t

    def linear(self, name: str, d_in: int, d_out: int) -> None:
        self.normal(f"{name}.weight", d_out, d_in)
        self.fixed(f"{name}.bias", 0.0, d_out)

    def norm(self, name: str, d: int) -> None:
        self.fixed(f"{name}.weight", 1.0, d)
        self.fixed(f"{name}.bias", 0.0, d)

    def encoder_layer(self, name: str, d: int, ffn: int) -> None:
        """A post-norm encoder layer: the weights of qkv, out_proj, ffn1, ffn2
        drawn in that order; biases 0 and norms 1, 0."""
        for sub, d_in, d_out in (("qkv", d, 3 * d), ("out_proj", d, d), ("ffn1", d, ffn),
                                 ("ffn2", ffn, d)):
            self.linear(f"{name}.{sub}", d_in, d_out)
        self.norm(f"{name}.norm1", d)
        self.norm(f"{name}.norm2", d)


def attention(q, k, v, key_pad: Optional[torch.Tensor], causal: bool) -> torch.Tensor:
    """q [B, H, Lq, Dh], k/v [B, H, Lk, Dh], key_pad [B, Lk] True = pad:
    softmax(q·kᵀ/√Dh) with masked scores at -1e30 and their weights 0, a
    fully masked row giving 0."""
    lq, lk, dh = q.shape[2], k.shape[2], q.shape[3]
    s = torch.matmul(q, k.transpose(-1, -2)) * (1.0 / dh ** 0.5)
    invalid = torch.zeros(1, 1, lq, lk, dtype=torch.bool, device=q.device)
    if causal:
        above = torch.ones(lq, lk, dtype=torch.bool, device=q.device).tril().logical_not()
        invalid = invalid | above
    if key_pad is not None:
        invalid = invalid | key_pad[:, None, None, :]
    s = s.masked_fill(invalid, NEG)
    e = torch.exp(s - s.amax(dim=-1, keepdim=True).detach()).masked_fill(invalid, 0.0)
    return torch.matmul(e / e.sum(dim=-1, keepdim=True).clamp_min(1e-30), v)


def heads(t: torch.Tensor, h: int) -> torch.Tensor:
    b, l, d = t.shape
    return t.reshape(b, l, h, d // h).transpose(1, 2)


def merge(t: torch.Tensor) -> torch.Tensor:
    b, h, l, dh = t.shape
    return t.transpose(1, 2).reshape(b, l, h * dh)


def gelu(x: torch.Tensor) -> torch.Tensor:
    return F.gelu(x, approximate="tanh")


def dense(p: Dict[str, torch.Tensor], name: str, x: torch.Tensor) -> torch.Tensor:
    return F.linear(x, p[f"{name}.weight"], p[f"{name}.bias"])


def norm(p: Dict[str, torch.Tensor], name: str, x: torch.Tensor, eps: float) -> torch.Tensor:
    return F.layer_norm(x, x.shape[-1:], p[f"{name}.weight"], p[f"{name}.bias"], eps)


def encoder_layer(p, name: str, x, key_pad, causal: bool, h: int, drop: float,
                  training: bool, eps: float = 1e-12) -> torch.Tensor:
    """Post-norm: x + dropout(attention), norm, x + dropout(FFN), norm; the
    three dropouts in the order out_proj, ffn1, ffn2."""
    q, k, v = (heads(t, h) for t in dense(p, f"{name}.qkv", x).split(x.shape[-1], dim=-1))
    a = attention(q, k, v, key_pad, causal)
    x = norm(p, f"{name}.norm1", x + F.dropout(dense(p, f"{name}.out_proj", merge(a)), drop,
                                               training), eps)
    y = F.dropout(gelu(dense(p, f"{name}.ffn1", x)), drop, training)
    y = F.dropout(dense(p, f"{name}.ffn2", y), drop, training)
    return norm(p, f"{name}.norm2", x + y, eps)


def on(params: Dict[str, torch.Tensor], device, grad: bool = False) -> Dict[str, torch.Tensor]:
    """The weights on ``device``, as leaves that take gradients if ``grad``."""
    return {k: v.to(device, copy=True).requires_grad_(grad) for k, v in params.items()}


def leaves(params: Dict[str, torch.Tensor]) -> List[torch.Tensor]:
    return list(params.values())
