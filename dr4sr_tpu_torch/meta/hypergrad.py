"""Implicit-gradient engine for bilevel optimization (DR4SR+).

Port of ``dr4sr_tpu/meta/hypergrad.py``, which follows the reference's
``Hypergrad`` (``utils/utils.py:134-255``) and "Optimizing Millions of
Hyperparameters by Implicit Differentiation" (Lorraine et al., 2020):

    hyper_grad(φ) = - d/dφ [ ∂L_train/∂W · p ],
    p ≈ (∂²L_train/∂W²)^{-1} ∂L_val/∂W   (truncated Neumann series)

Trees are dicts of tensors. The Hessian-vector products run
reverse-over-reverse, as the reference's do: ∂L_train/∂W is built once with
``create_graph=True``, every H·v is a backward through that graph, and so is
the final d/dφ. One forward of the train loss serves them all, so its
negatives, dropout masks and Gumbel noise are the same in every product, as
the JAX package's single ``r_train`` key makes them. Every function the
products pass through must differentiate twice: attention through
``ops.attention.plain_attention()``, a cuDNN RNN with cuDNN off.
"""

from __future__ import annotations

from typing import Callable, Dict, List, Optional

import torch

from dr4sr_tpu_torch.parallel.collectives import Axis, all_reduce_

Tree = Dict[str, torch.Tensor]


def tree_add(a: Tree, b: Tree) -> Tree:
    return {k: a[k] + b[k] for k in a}


def tree_sub(a: Tree, b: Tree) -> Tree:
    return {k: a[k] - b[k] for k in a}


def tree_scale(a: Tree, s) -> Tree:
    return {k: x * s for k, x in a.items()}


def tree_vdot(a: Tree, b: Tree) -> torch.Tensor:
    return sum((a[k] * b[k]).sum() for k in a)


def tree_global_norm(a: Tree) -> torch.Tensor:
    return torch.sqrt(sum((x * x).sum() for x in a.values()))


def clip_by_global_norm(a: Tree, max_norm: float) -> Tree:
    """``a`` scaled down to a global norm of ``max_norm``, if above it."""
    norm = tree_global_norm(a)
    scale = torch.clamp(max_norm / torch.clamp(norm, min=1e-12), max=1.0)
    return tree_scale(a, scale)


def gumbel_topk_relaxation(
    scores: torch.Tensor, k: int, tau: float = 1.0, hard: bool = False,
    eps: float = 1e-10, noise: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Continuous top-k relaxation by iterated Gumbel-softmax (reference
    ``SubsetOperator``, ``utils/utils.py:257-288``): a [B, N] k-hot
    relaxation of ``scores`` + ``noise`` (standard Gumbel draws of its
    shape; none when None); ``hard`` straight-throughs onto the exact top-k."""
    if noise is not None:
        scores = scores + noise
    khot = torch.zeros_like(scores)
    onehot_approx = torch.zeros_like(scores)
    for _ in range(k):
        mask = torch.clamp(1.0 - onehot_approx, min=eps)
        scores = scores + torch.log(mask)
        onehot_approx = torch.softmax(scores / tau, dim=-1)
        khot = khot + onehot_approx
    if hard:
        idx = torch.topk(khot, k, dim=-1).indices
        hard_khot = torch.zeros_like(khot).scatter_(-1, idx, 1.0)
        khot = hard_khot - khot.detach() + khot
    return khot


def _grads(outputs, inputs, grad_outputs=None, create_graph=False) -> list:
    """``torch.autograd.grad`` with zeros for inputs the outputs do not
    reach; outputs that do not require grad (a gradient constant in every
    input) contribute nothing."""
    if not isinstance(outputs, (list, tuple)):
        outputs, grad_outputs = [outputs], None if grad_outputs is None else [grad_outputs]
    keep = [i for i, o in enumerate(outputs) if o is not None and o.requires_grad]
    if not keep:
        return [torch.zeros_like(x) for x in inputs]
    got = torch.autograd.grad(
        [outputs[i] for i in keep], inputs,
        None if grad_outputs is None else [grad_outputs[i] for i in keep],
        retain_graph=True, create_graph=create_graph, allow_unused=True)
    return [torch.zeros_like(x) if g is None else g for x, g in zip(inputs, got)]


def _sum_over(grads: List[torch.Tensor], axis: Optional[Axis]) -> List[torch.Tensor]:
    """Each tensor summed over ``axis``, all in one all-reduce; no gradient."""
    if axis is None:
        return grads
    flat = torch.cat([g.detach().reshape(-1) for g in grads])
    all_reduce_(flat, axis)
    return [x.view_as(g) for x, g in zip(flat.split([g.numel() for g in grads]), grads)]


def hypergradient(
    train_loss_fn: Callable[[Tree, Tree], torch.Tensor],  # (params, meta) -> loss
    val_loss_fn: Callable[[Tree], torch.Tensor],  # params -> loss
    params: Tree,
    meta_params: Tree,
    lr: float = 0.1,
    truncate_iter: int = 3,
    axis: Optional[Axis] = None,
) -> Tree:
    """dL_val/dφ by the truncated-Neumann inverse-HVP, the reference's
    iteration (``utils/utils.py:180-205``):

        p = v = dL_val/dW
        repeat truncate_iter: v ← v − lr·H·v ;  p ← p + v
        hyper_grads = − d/dφ [ dL_train/dW · p ]

    ``params`` (W) and ``meta_params`` (φ) are dicts of tensors that
    require grad; each loss function is called once and must compute its
    loss from those tensors (directly, or through a module whose parameters
    they are). ``axis`` (the data axis): each loss is this rank's share,
    and every derivative is summed over it (see the module docstring).
    Returns a dict of φ's shapes; no ``.grad`` is written."""
    w_names = list(params)
    w = [params[k] for k in w_names]
    m = list(meta_params.values())
    v1 = dict(zip(w_names, _sum_over(_grads(val_loss_fn(params), w), axis)))
    g = dict(zip(w_names, _grads(train_loss_fn(params, meta_params), w, create_graph=True)))

    def hvp(v: Tree) -> Tree:
        hv = _grads([g[k] for k in w_names], w, [v[k] for k in w_names])
        return dict(zip(w_names, _sum_over(hv, axis)))

    p = v = v1
    for _ in range(truncate_iter):
        v = tree_sub(v, tree_scale(hvp(v), lr))
        p = tree_add(p, v)
    v3 = _sum_over(_grads(tree_vdot(g, p), m), axis)  # p is a constant: d/dφ [g · p]
    return {k: -x for k, x in zip(meta_params, v3)}
