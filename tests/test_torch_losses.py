"""The port's losses against ``dr4sr_tpu.modules.losses`` on the same scores,
at atol 1e-6 (f32 arithmetic in both, sums in another order)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dr4sr_tpu.modules import losses as jax_losses
from dr4sr_tpu_torch.modules import losses

ATOL = 1e-6


def _scores(seed, per_position, all_masked=False):
    rng = np.random.default_rng(seed)
    b, l, n = 4, 6, 3
    pos = rng.normal(size=(b, l) if per_position else (b,)).astype(np.float32)
    neg_shape = (b, l, n) if per_position else (b, n)
    neg = rng.normal(size=neg_shape).astype(np.float32)
    mask = rng.random(size=pos.shape) > 0.3
    if all_masked:
        mask[:] = False
    return pos, neg, mask


def _check(got, want):
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL)


@pytest.mark.parametrize("all_masked", [False, True])
@pytest.mark.parametrize("reduce", [True, False])
@pytest.mark.parametrize("per_position", [True, False])
@pytest.mark.parametrize("name", ["binary_cross_entropy_loss", "bpr_loss"])
def test_ranking_losses_match_jax(name, per_position, reduce, all_masked):
    pos, neg, mask = _scores(0, per_position, all_masked)
    want = getattr(jax_losses, name)(*map(jnp.asarray, (pos, neg, mask)), reduce=reduce)
    got = getattr(losses, name)(*map(torch.from_numpy, (pos, neg, mask)), reduce=reduce)
    assert got.dtype == torch.float32
    _check(got, want)


def test_losses_take_bf16_scores_in_f32():
    pos, neg, mask = _scores(1, True)
    want = jax_losses.binary_cross_entropy_loss(
        jnp.asarray(pos).astype(jnp.bfloat16), jnp.asarray(neg).astype(jnp.bfloat16),
        jnp.asarray(mask))
    got = losses.binary_cross_entropy_loss(torch.from_numpy(pos).bfloat16(),
                                           torch.from_numpy(neg).bfloat16(),
                                           torch.from_numpy(mask))
    assert got.dtype == torch.float32
    _check(got, want)


@pytest.mark.parametrize("with_valid", [False, True])
def test_alignment_and_uniformity_match_jax(with_valid):
    rng = np.random.default_rng(2)
    x = rng.normal(size=(10, 8)).astype(np.float32)
    y = rng.normal(size=(10, 8)).astype(np.float32)
    x[3] = 0.0  # a zero row: the norm's 1e-12 floor
    valid = rng.random(10) > 0.4 if with_valid else None
    jv = None if valid is None else jnp.asarray(valid)
    tv = None if valid is None else torch.from_numpy(valid)
    _check(losses.alignment(torch.from_numpy(x), torch.from_numpy(y), tv),
           jax_losses.alignment(jnp.asarray(x), jnp.asarray(y), jv))
    _check(losses.uniformity(torch.from_numpy(x), tv), jax_losses.uniformity(jnp.asarray(x), jv))
