"""The port's pooling, length mask and TransformerEncoder against the flax
modules of the JAX package, with weights carried over by ``convert.py``.

atol 2e-5 in f32: sums run in another order, and flax's LayerNorm takes the
variance in one pass (E[x²] − E[x]²) where PyTorch takes two.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dr4sr_tpu.modules import layers as jax_layers
from dr4sr_tpu_torch.convert import sasrec_params_from_jax
from dr4sr_tpu_torch.modules.layers import TransformerEncoder, length_mask, seq_pooling

POOLINGS = ["mean", "sum", "max", "last", "origin", "concat", "mask"]


@pytest.mark.parametrize("weighted", [False, True])
@pytest.mark.parametrize("pooling", POOLINGS)
def test_seq_pooling_matches_jax(pooling, weighted):
    rng = np.random.default_rng(0)
    b, l, d = 4, 7, 5
    x = rng.normal(size=(b, l, d)).astype(np.float32)
    seqlen = np.array([7, 3, 1, 0])
    weight = rng.random(size=(b, l)).astype(np.float32) if weighted else None
    mask_token = np.zeros((b, l), bool)
    mask_token[np.arange(b), rng.integers(0, l, size=b)] = True
    want = jax_layers.seq_pooling(
        jnp.asarray(x), jnp.asarray(seqlen), pooling,
        weight=None if weight is None else jnp.asarray(weight),
        mask_token=jnp.asarray(mask_token),
    )
    got = seq_pooling(
        torch.from_numpy(x), torch.from_numpy(seqlen), pooling,
        weight=None if weight is None else torch.from_numpy(weight),
        mask_token=torch.from_numpy(mask_token),
    )
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-6)


def test_length_mask_matches_jax():
    seqlen = np.array([0, 1, 5, 9])
    want = jax_layers.length_mask(jnp.asarray(seqlen), 9)
    got = length_mask(torch.from_numpy(seqlen), 9)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def _encoders(seed):
    d, h, ffn, layers = 16, 2, 32, 2
    jax_enc = jax_layers.TransformerEncoder(num_layers=layers, embed_dim=d, num_heads=h, ffn_dim=ffn)
    x = np.random.default_rng(seed).normal(size=(3, 12, d)).astype(np.float32)
    params = jax_enc.init(jax.random.PRNGKey(seed), jnp.asarray(x))["params"]
    enc = TransformerEncoder(layers, d, h, ffn)
    enc.load_state_dict(sasrec_params_from_jax(jax.tree_util.tree_map(np.asarray, params), enc))
    return jax_enc, params, enc, x


@pytest.mark.parametrize("causal", [True, False])
def test_transformer_encoder_matches_flax(causal):
    jax_enc, params, enc, x = _encoders(0)
    mask = np.arange(12)[None, :] >= np.array([12, 5, 0])[:, None]
    want = jax_enc.apply({"params": params}, jnp.asarray(x), jnp.asarray(mask), causal)
    with torch.no_grad():
        got = enc.eval()(torch.from_numpy(x), torch.from_numpy(mask), causal)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=2e-5)


def test_remat_keeps_output_and_gradients():
    _, _, enc, x = _encoders(1)
    xt = torch.from_numpy(x)
    outs = []
    for remat in (False, True):
        enc.remat = remat
        enc.zero_grad()
        out = enc.eval()(xt, None, True)
        out.square().sum().backward()
        outs.append((out.detach(), [p.grad.clone() for p in enc.parameters()]))
    torch.testing.assert_close(outs[0][0], outs[1][0], rtol=0, atol=0)
    for g0, g1 in zip(outs[0][1], outs[1][1]):
        torch.testing.assert_close(g0, g1, rtol=0, atol=0)
