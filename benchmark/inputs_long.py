"""Long histories over a large catalog, made from ``--seed``: MovieLens-20M's
counts (138,493 users, 20,000,263 interactions, at least 5 a user: mean
144.4) with items drawn by Zipf popularity.

The lengths are one fixed multiset, the same for every seed, made as
``inputs.lengths`` makes Toys' (the minimum of 5 plus the floor of evenly
spaced quantiles of an exponential whose scale is fitted by bisection, the
remainder one each to the longest). ``inputs.lengths`` brackets the scale
in [0, 64], which holds Toys' mean of 8.6 but not ML-20M's 144.4; here the
bracket grows until it holds the total. The seed says which user gets
which length, which item id has which popularity rank (a permutation of
ids 1 .. ``num_items`` − 1), and the draws: item i of rank r is drawn with
probability ∝ r^−exponent, independently at every position. Popular items
are the same for all users, so their tokens crowd a few experts, as real
item popularity does.

The rows are written with ``inputs.write_dataset``, unchanged.
"""

from __future__ import annotations

from typing import List

import numpy as np

from inputs import MIN_LEN


def lengths(num_users: int, num_interactions: int) -> np.ndarray:
    """The fixed multiset of sequence lengths, ascending, summing to
    ``num_interactions``."""
    u = (np.arange(num_users) + 0.5) / num_users
    tail = -np.log1p(-u)
    want = num_interactions - MIN_LEN * num_users
    hi = 64.0
    while np.floor(tail * hi).sum() <= want:
        hi *= 2
    lo = 0.0
    for _ in range(100):
        mid = 0.5 * (lo + hi)
        if np.floor(tail * mid).sum() > want:
            hi = mid
        else:
            lo = mid
    extra = np.floor(tail * lo).astype(np.int64)
    extra[len(extra) - (want - int(extra.sum())):] += 1
    return MIN_LEN + extra


def zipf_sequences(seed: int, num_users: int, num_items: int, num_interactions: int,
                   exponent: float) -> List[np.ndarray]:
    """One int64 item sequence per user; ids 1 to ``num_items`` − 1."""
    rng = np.random.default_rng([seed, 19])
    lens = rng.permutation(lengths(num_users, num_interactions))
    ids = rng.permutation(np.arange(1, num_items, dtype=np.int64))  # ids[r]: rank r + 1
    cdf = np.cumsum(np.arange(1, num_items, dtype=np.float64) ** -exponent)
    ranks = np.searchsorted(cdf, rng.random(int(lens.sum())) * cdf[-1], side="right")
    items = ids[np.minimum(ranks, num_items - 2)]
    return np.split(items, np.cumsum(lens)[:-1])
