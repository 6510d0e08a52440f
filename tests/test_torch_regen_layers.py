"""The regenerator's building blocks against the flax modules of the JAX
package: ``MLP``, ``TransformerDecoderLayer`` and ``TransformerDecoder``
(full-sequence pass, ``project_memory``, the KV-cached ``step``), at a small
width (D = 32, 2 heads, 2 layers), weights carried over by
``convert.generator_params_from_jax``.

atol 2e-5 in f32, as ``tests/test_torch_layers.py``: sums run in another
order, and flax's LayerNorm takes the variance in one pass.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dr4sr_tpu.modules import layers as jax_layers
from dr4sr_tpu_torch.convert import generator_params_from_jax
from dr4sr_tpu_torch.modules.layers import MLP, TransformerDecoder, TransformerDecoderLayer, _attend_one
from torch_one_thread import one_torch_thread  # noqa: F401  (autouse)

D, H, FFN, LAYERS = 32, 2, 64, 2
ATOL = 2e-5


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _inputs(seed, b=3, lt=9, ls=13):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(b, lt, D)).astype(np.float32)
    mem = rng.normal(size=(b, ls, D)).astype(np.float32)
    tgt_pad = np.arange(lt)[None, :] >= np.array([lt, 4, 1])[:, None]
    mem_pad = np.arange(ls)[None, :] >= np.array([ls, 6, 0])[:, None]  # one fully masked row
    return x, mem, tgt_pad, mem_pad


@pytest.mark.parametrize("features", [(D,), (D, 2 * D), (D, D, 5)])
def test_mlp_matches_flax(features):
    x = np.random.default_rng(0).normal(size=(4, 6, 12)).astype(np.float32)
    jax_mlp = jax_layers.MLP(tuple(features))
    params = jax_mlp.init(jax.random.PRNGKey(0), jnp.asarray(x))["params"]
    mlp = MLP(12, features)
    mlp.load_state_dict(generator_params_from_jax(_np(params), mlp))
    want = jax_mlp.apply({"params": params}, jnp.asarray(x))
    with torch.no_grad():
        got = mlp(torch.from_numpy(x))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL)


def _decoder(seed, cls_jax, cls_torch, *args):
    x, mem, tgt_pad, mem_pad = _inputs(seed)
    jax_mod = cls_jax(*args, embed_dim=D, num_heads=H, ffn_dim=FFN)
    params = jax_mod.init(jax.random.PRNGKey(seed), jnp.asarray(x), jnp.asarray(mem))["params"]
    mod = cls_torch(*args, D, H, FFN)
    mod.load_state_dict(generator_params_from_jax(_np(params), mod))
    return jax_mod, params, mod.eval(), (x, mem, tgt_pad, mem_pad)


@pytest.mark.parametrize("stack", [False, True], ids=["layer", "decoder"])
@pytest.mark.parametrize("causal", [True, False])
def test_decoder_forward_matches_flax(stack, causal):
    if stack:
        jax_mod, params, mod, (x, mem, tp, mp) = _decoder(
            1, jax_layers.TransformerDecoder, TransformerDecoder, LAYERS)
    else:
        jax_mod, params, mod, (x, mem, tp, mp) = _decoder(
            1, jax_layers.TransformerDecoderLayer, TransformerDecoderLayer)
    want = jax_mod.apply({"params": params}, jnp.asarray(x), jnp.asarray(mem), jnp.asarray(tp),
                         jnp.asarray(mp), causal)
    with torch.no_grad():
        got = mod(*(torch.from_numpy(a) for a in (x, mem, tp, mp)), causal)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL)


def test_decoder_gradients_flow_through_cross_attention():
    """Gradients reach the memory (and so the encoder) through cross_kv."""
    _, _, mod, (x, mem, tp, mp) = _decoder(2, jax_layers.TransformerDecoder, TransformerDecoder,
                                           LAYERS)
    memory = torch.from_numpy(mem).requires_grad_()
    mod(torch.from_numpy(x), memory, torch.from_numpy(tp), torch.from_numpy(mp)).sum().backward()
    grad = memory.grad.abs().sum(-1)
    assert (grad[torch.from_numpy(mp)] == 0).all()  # padded memory gets none
    assert (grad[~torch.from_numpy(mp)] > 0).all()


def test_project_memory_matches_flax():
    jax_mod, params, mod, (_, mem, _, _) = _decoder(3, jax_layers.TransformerDecoder,
                                                    TransformerDecoder, LAYERS)
    want = jax_mod.apply({"params": params}, jnp.asarray(mem),
                         method=jax_layers.TransformerDecoder.project_memory)
    with torch.no_grad():
        got = mod.project_memory(torch.from_numpy(mem))
    for g, w in zip(got, want):
        assert g.shape == (LAYERS, *mem.shape)
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=ATOL)


def test_cached_step_matches_flax_and_the_full_pass():
    """Position by position, ``step`` equals flax's ``step`` (outputs and
    caches) and the full causal pass at that position."""
    jax_mod, params, mod, (x, mem, tp, mp) = _decoder(4, jax_layers.TransformerDecoder,
                                                      TransformerDecoder, LAYERS)
    b, lt, _ = x.shape
    no_pad = np.zeros_like(tp)
    jk, jv = jax_mod.apply({"params": params}, jnp.asarray(mem),
                           method=jax_layers.TransformerDecoder.project_memory)
    jck = jnp.zeros((LAYERS, b, lt, D))
    jcv = jnp.zeros_like(jck)
    with torch.no_grad():
        mk, mv = mod.project_memory(torch.from_numpy(mem))
        ck = torch.zeros(LAYERS, b, lt, D)
        cv = torch.zeros_like(ck)
        full = mod(torch.from_numpy(x), torch.from_numpy(mem), torch.from_numpy(no_pad),
                   torch.from_numpy(mp))
        for pos in range(lt):
            jy, jck, jcv = jax_mod.apply(
                {"params": params}, jnp.asarray(x[:, pos]), jck, jcv, pos, jk, jv,
                jnp.asarray(~mp), method=jax_layers.TransformerDecoder.step)
            y = mod.step(torch.from_numpy(x[:, pos]), ck, cv, pos, mk, mv, torch.from_numpy(~mp))
            np.testing.assert_allclose(y.numpy(), np.asarray(jy), atol=ATOL)
            np.testing.assert_allclose(y.numpy(), full[:, pos].numpy(), atol=ATOL)
        np.testing.assert_allclose(ck.numpy(), np.asarray(jck), atol=ATOL)
        np.testing.assert_allclose(cv.numpy(), np.asarray(jcv), atol=ATOL)


def test_attend_one_matches_jax_with_a_fully_masked_row():
    rng = np.random.default_rng(5)
    q = rng.normal(size=(3, D)).astype(np.float32)
    k, v = (rng.normal(size=(3, 7, D)).astype(np.float32) for _ in range(2))
    valid = np.arange(7)[None, :] < np.array([7, 3, 0])[:, None]
    want = jax_layers._attend_one(*(jnp.asarray(a) for a in (q, k, v, valid)), H)
    got = _attend_one(*(torch.from_numpy(a) for a in (q, k, v, valid)), H)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL)
    assert (got[2] == 0).all()
