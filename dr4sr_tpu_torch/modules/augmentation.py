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

:func:`sample_draws` draws one kind's tensors; for ``item_random`` it first
picks ONE branch for the whole batch (JAX's ``lax.switch``), not one per
row. :func:`augment` = :func:`apply_draws` ∘ :func:`sample_draws`.
:func:`random_augmentation` picks per row between a draw for short rows and
one for long rows (reference ``Random_Augmentation``).
"""

from __future__ import annotations

from typing import Dict, Optional, Sequence, Tuple

import torch

Seq = torch.Tensor  # [B, L] int
Lens = torch.Tensor  # [B] int
Draws = Dict[str, object]  # {"kind": str, "start": [B] or None, "u": [B, L] or None}

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


def _window_starts(generator: Optional[torch.Generator], seqlen: Lens, sub_len: Lens) -> Lens:
    """Uniform over [0, max(len − sub_len + 1, 1))."""
    hi = torch.clamp(seqlen - sub_len + 1, min=1)
    u = torch.rand(seqlen.shape, generator=generator, device=seqlen.device)
    return torch.minimum((u * hi).to(seqlen.dtype), hi - 1)


def sample_draws(generator: Optional[torch.Generator], seq: Seq, seqlen: Lens, kind: str,
                 tao: float = 0.2, beta: float = 0.2) -> Draws:
    """The draws of one ``kind`` for this batch; ``item_random`` picks the
    kind first, one for the whole batch."""
    if kind == "item_random":
        pick = torch.randint(0, len(KINDS), (1,), generator=generator, device=seq.device)
        kind = KINDS[int(pick)]
    draws: Draws = {"kind": kind, "start": None, "u": None}
    if kind == "item_crop":
        draws["start"] = _window_starts(generator, seqlen, crop_len(seqlen, tao))
    elif kind == "item_mask":
        draws["u"] = torch.rand(seq.shape, generator=generator, device=seq.device)
    elif kind == "item_reorder":
        draws["start"] = _window_starts(generator, seqlen, _scaled_len(beta, seqlen))
        draws["u"] = torch.rand(seq.shape, generator=generator, device=seq.device)
    else:
        raise ValueError(f"unknown augmentation kind {kind!r}")
    return draws


def apply_draws(seq: Seq, seqlen: Lens, draws: Draws, tao: float = 0.2, gamma: float = 0.7,
                beta: float = 0.2, mask_id: int = 0) -> Tuple[Seq, Lens]:
    kind = draws["kind"]
    if kind == "item_crop":
        return item_crop(seq, seqlen, tao, draws["start"])
    if kind == "item_mask":
        return item_mask(seq, seqlen, gamma, mask_id, draws["u"])
    if kind == "item_reorder":
        return item_reorder(seq, seqlen, beta, draws["start"], draws["u"])
    raise ValueError(f"unknown augmentation kind {kind!r}")


def augment(generator: Optional[torch.Generator], seq: Seq, seqlen: Lens,
            kind: str = "item_random", tao: float = 0.2, gamma: float = 0.7,
            beta: float = 0.2, mask_id: int = 0) -> Tuple[Seq, Lens]:
    draws = sample_draws(generator, seq, seqlen, kind, tao=tao, beta=beta)
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
    ``short_kinds`` (one pick of each a batch). ``draws`` gives the (short,
    long) draws instead of sampling them."""
    if draws is None:
        draws = tuple(
            sample_draws(generator, seq, seqlen,
                         kinds[int(torch.randint(0, len(kinds), (1,), generator=generator,
                                                 device=seq.device))],
                         tao=tao, beta=beta)
            for kinds in (short_kinds, long_kinds))
    kw = dict(tao=tao, gamma=gamma, beta=beta, mask_id=mask_id)
    s_seq, s_len = apply_draws(seq, seqlen, draws[0], **kw)
    l_seq, l_len = apply_draws(seq, seqlen, draws[1], **kw)
    is_long = seqlen > augment_threshold
    return torch.where(is_long[:, None], l_seq, s_seq), torch.where(is_long, l_len, s_len)
