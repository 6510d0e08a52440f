"""Stochastic sequence augmentations (CL4SRec), batched and fixed-shape.

Port of ``dr4sr_tpu/modules/augmentation.py``. Each transform is a function
of its random **draws**, so the same draws give the same views in both
packages; a thin sampler makes the draws from a ``torch.Generator`` (the
streams of ``jax.random`` and torch differ, so tests feed JAX's draws in):

* :func:`item_crop` (``start`` [B]) — keep the window of
  ``max(1, int(tao·len))`` items from ``start``, packed to the front, the
  rest 0;
* :func:`item_mask` (``u`` [B, L] uniforms) — the ``int(gamma·len)`` real
  positions with the smallest uniforms become ``mask_id``;
* :func:`item_reorder` (``start`` [B], ``u`` [B, L]) — the window of
  ``int(beta·len)`` items from ``start`` is shuffled in place by sorting
  ``start + u`` inside it against each outside position's own index.

:func:`sample_draws` draws one kind's tensors. ``item_random`` picks ONE
branch for the whole batch (JAX's ``lax.switch``), not one per row, and
picks it on the device: it draws one fixed layout whatever the pick, in
this order — ``pick`` [1] (an index into the kinds), one ``start`` uniform
[B] that crop and reorder each scale by their own window, one ``u`` [B, L]
that mask and reorder share — and :func:`apply_draws` computes every
branch's view and selects one with ``torch.where`` on the pick. Nothing
reads the pick on the host, so a CUDA graph of the step holds it, and the
per-step path and a graph of N steps draw one stream. (Before the pick
moved to the device, ``item_random`` drew the pick, then only the chosen
branch's tensors: that stream is gone, at N = 1 too.)

Under data parallelism (``axis``, the data axis) the draws are made for
the global batch from a generator in lockstep on every rank, and each rank
keeps its rows, so the ranks' views are one process's, draw for draw; the
pick is one draw a batch, the same on every rank.
:func:`augment` = :func:`apply_draws` ∘ :func:`sample_draws`.
:func:`random_augmentation` picks per row between a draw for short rows and
one for long rows (reference ``Random_Augmentation``), each a device pick.
"""

from __future__ import annotations

from typing import Dict, Optional, Sequence, Tuple

import torch

from dr4sr_tpu_torch.parallel.collectives import Axis

Seq = torch.Tensor  # [B, L] int
Lens = torch.Tensor  # [B] int
Draws = Dict[str, object]
# one kind: {"kind": str, "start": [B] or None, "u": [B, L] or None};
# item_random: {"kind": "item_random", "pick": [1], "branches": [one kind's draws, ...]}

KINDS = ("item_crop", "item_mask", "item_reorder")


def _scaled_len(ratio: float, seqlen: Lens) -> Lens:
    """``int(ratio · len)`` in f32, as JAX's ``(ratio * seqlen).astype(int32)``."""
    return (ratio * seqlen.to(torch.float32)).to(seqlen.dtype)


def crop_len(seqlen: Lens, tao: float) -> Lens:
    return torch.clamp(_scaled_len(tao, seqlen), min=1)


def item_crop(seq: Seq, seqlen: Lens, tao: float, start: Lens) -> Tuple[Seq, Lens]:
    l = seq.shape[1]
    sub_len = crop_len(seqlen, tao)
    pos = torch.arange(l, device=seq.device)[None, :]
    src = torch.clamp(start[:, None] + pos, 0, l - 1)
    out = torch.gather(seq, 1, src)
    return torch.where(pos < sub_len[:, None], out, 0), sub_len


def item_mask(seq: Seq, seqlen: Lens, gamma: float, mask_id: int,
              u: torch.Tensor) -> Tuple[Seq, Lens]:
    l = seq.shape[1]
    sub_len = _scaled_len(gamma, seqlen)
    pos = torch.arange(l, device=seq.device)[None, :]
    u = torch.where(pos < seqlen[:, None], u, float("inf"))
    # each position's rank among its row's uniforms; the lowest sub_len masked
    rank = torch.argsort(torch.argsort(u, dim=1, stable=True), dim=1, stable=True)
    return torch.where(rank < sub_len[:, None], mask_id, seq), seqlen


def item_reorder(seq: Seq, seqlen: Lens, beta: float, start: Lens,
                 u: torch.Tensor) -> Tuple[Seq, Lens]:
    l = seq.shape[1]
    sub_len = _scaled_len(beta, seqlen)
    pos = torch.arange(l, device=seq.device)[None, :]
    in_window = (pos >= start[:, None]) & (pos < (start + sub_len)[:, None])
    sort_key = torch.where(in_window, start[:, None].to(torch.float32) + u,
                           pos.to(torch.float32))
    perm = torch.argsort(sort_key, dim=1, stable=True)
    return torch.gather(seq, 1, perm), seqlen


def _rand(generator: Optional[torch.Generator], shape, device,
          axis: Optional[Axis]) -> torch.Tensor:
    """Uniforms of ``shape``; given the data axis, drawn for the global batch
    (``shape[0]`` × the axis size rows) and cut to this rank's rows."""
    if axis is None:
        return torch.rand(shape, generator=generator, device=device)
    u = torch.rand((shape[0] * axis.size,) + tuple(shape[1:]), generator=generator,
                   device=device)
    return axis.chunk(u, 0)


def _scaled_starts(u: torch.Tensor, seqlen: Lens, sub_len: Lens) -> Lens:
    """Window starts uniform over [0, max(len − sub_len + 1, 1)) from uniforms ``u`` [B]."""
    hi = torch.clamp(seqlen - sub_len + 1, min=1)
    return torch.minimum((u * hi).to(seqlen.dtype), hi - 1)


def _kind_draws(kind: str, seqlen: Lens, start_u: Optional[torch.Tensor],
                u: Optional[torch.Tensor], tao: float, beta: float) -> Draws:
    """One kind's draws from a ``start`` uniform [B] and uniforms ``u`` [B, L]."""
    if kind == "item_crop":
        return {"kind": kind, "start": _scaled_starts(start_u, seqlen, crop_len(seqlen, tao)),
                "u": None}
    if kind == "item_mask":
        return {"kind": kind, "start": None, "u": u}
    if kind == "item_reorder":
        return {"kind": kind, "start": _scaled_starts(start_u, seqlen, _scaled_len(beta, seqlen)),
                "u": u}
    raise ValueError(f"unknown augmentation kind {kind!r}")


def random_draws(generator: Optional[torch.Generator], seq: Seq, seqlen: Lens,
                 kinds: Sequence[str] = KINDS, tao: float = 0.2, beta: float = 0.2,
                 axis: Optional[Axis] = None) -> Draws:
    """One of ``kinds`` for the whole batch, picked on the device: ``pick``
    [1], then one ``start`` uniform [B] and one ``u`` [B, L], whatever the
    pick; each branch's draws are made from them."""
    pick = torch.randint(0, len(kinds), (1,), generator=generator, device=seq.device)
    start_u = _rand(generator, seqlen.shape, seq.device, axis)
    u = _rand(generator, seq.shape, seq.device, axis)
    return {"kind": "item_random", "pick": pick,
            "branches": [_kind_draws(k, seqlen, start_u, u, tao, beta) for k in kinds]}


def sample_draws(generator: Optional[torch.Generator], seq: Seq, seqlen: Lens, kind: str,
                 tao: float = 0.2, beta: float = 0.2, axis: Optional[Axis] = None) -> Draws:
    """The draws of one ``kind`` for this batch (``item_random``:
    :func:`random_draws` over the three kinds). ``axis`` (the data axis):
    this rank's rows of the global batch's draws."""
    if kind == "item_random":
        return random_draws(generator, seq, seqlen, KINDS, tao=tao, beta=beta, axis=axis)
    if kind not in KINDS:
        raise ValueError(f"unknown augmentation kind {kind!r}")
    start_u = _rand(generator, seqlen.shape, seq.device, axis) if kind != "item_mask" else None
    u = _rand(generator, seq.shape, seq.device, axis) if kind != "item_crop" else None
    return _kind_draws(kind, seqlen, start_u, u, tao, beta)


def apply_draws(seq: Seq, seqlen: Lens, draws: Draws, tao: float = 0.2, gamma: float = 0.7,
                beta: float = 0.2, mask_id: int = 0) -> Tuple[Seq, Lens]:
    kind = draws["kind"]
    if kind == "item_random":  # every branch, then the picked one's view
        views = [apply_draws(seq, seqlen, b, tao=tao, gamma=gamma, beta=beta, mask_id=mask_id)
                 for b in draws["branches"]]
        out_seq, out_len = views[-1]
        for i in range(len(views) - 2, -1, -1):
            hit = draws["pick"] == i
            out_seq = torch.where(hit, views[i][0], out_seq)
            out_len = torch.where(hit, views[i][1], out_len)
        return out_seq, out_len
    if kind == "item_crop":
        return item_crop(seq, seqlen, tao, draws["start"])
    if kind == "item_mask":
        return item_mask(seq, seqlen, gamma, mask_id, draws["u"])
    if kind == "item_reorder":
        return item_reorder(seq, seqlen, beta, draws["start"], draws["u"])
    raise ValueError(f"unknown augmentation kind {kind!r}")


def augment(generator: Optional[torch.Generator], seq: Seq, seqlen: Lens,
            kind: str = "item_random", tao: float = 0.2, gamma: float = 0.7,
            beta: float = 0.2, mask_id: int = 0, axis: Optional[Axis] = None) -> Tuple[Seq, Lens]:
    draws = sample_draws(generator, seq, seqlen, kind, tao=tao, beta=beta, axis=axis)
    return apply_draws(seq, seqlen, draws, tao=tao, gamma=gamma, beta=beta, mask_id=mask_id)


def random_augmentation(
    generator: Optional[torch.Generator],
    seq: Seq,
    seqlen: Lens,
    augment_threshold: int,
    short_kinds: Sequence[str] = ("item_mask",),
    long_kinds: Sequence[str] = KINDS,
    tao: float = 0.2,
    gamma: float = 0.7,
    beta: float = 0.2,
    mask_id: int = 0,
    draws: Optional[Tuple[Draws, Draws]] = None,
) -> Tuple[Seq, Lens]:
    """Length-conditioned augmentation (reference ``Random_Augmentation``,
    ``module/data_augmentation.py:194-223``): rows longer than the threshold
    take a kind drawn from ``long_kinds``, the others one from
    ``short_kinds`` (one device pick of each a batch, :func:`random_draws`).
    ``draws`` gives the (short, long) draws instead of sampling them."""
    if draws is None:
        draws = tuple(random_draws(generator, seq, seqlen, kinds, tao=tao, beta=beta)
                      for kinds in (short_kinds, long_kinds))
    kw = dict(tao=tao, gamma=gamma, beta=beta, mask_id=mask_id)
    s_seq, s_len = apply_draws(seq, seqlen, draws[0], **kw)
    l_seq, l_len = apply_draws(seq, seqlen, draws[1], **kw)
    is_long = seqlen > augment_threshold
    return torch.where(is_long[:, None], l_seq, s_seq), torch.where(is_long, l_len, s_len)
