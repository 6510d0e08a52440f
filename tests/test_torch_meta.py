"""The port's bilevel (DR4SR+) building blocks against the JAX package, on
the CPU:

* ``meta.hypergrad.hypergradient`` (reverse-over-reverse Hessian-vector
  products) against the closed form on a quadratic (rtol 1e-5, as
  tests/test_meta.py) and against JAX's (forward-over-reverse) on the same
  nonlinear function (rtol 1e-4, atol 1e-7: f32, different orders of
  summation);
* ``clip_by_global_norm``, ``gumbel_softmax_weight`` and
  ``gumbel_topk_relaxation`` (soft and hard, with its straight-through
  gradient) given JAX's Gumbel noise, within 1e-6 (the relaxation's
  gradient, back through k softmaxes at τ = 0.5, within 1e-5);
* ``utils.reparam``'s count and round trip, ``convert.meta_params_from_jax``;
* ``BatchIterator.sample_batch``: the same rows as the JAX loader's, bit
  for bit, interleaved with epochs;
* the attention repairs: a second derivative through ``FlashAttention``
  raises, and ``plain_attention()`` routes and restores.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dr4sr_tpu.data.dataset import prepare_datasets as jax_prepare_datasets
from dr4sr_tpu.data.loader import BatchIterator as JaxBatchIterator
from dr4sr_tpu.data.synthetic import synthetic_config as jax_synthetic_config
from dr4sr_tpu.data.synthetic import write_synthetic_dataset as jax_write
from dr4sr_tpu.meta import hypergrad as jax_hg
from dr4sr_tpu.models.metamodel import gumbel_softmax_weight as jax_gumbel_softmax_weight
from dr4sr_tpu.modules.layers import MLP as JaxMLP
from dr4sr_tpu.utils.reparam import flat_param_count as jax_flat_param_count
from dr4sr_tpu_torch.convert import meta_params_from_jax
from dr4sr_tpu_torch.data.dataset import prepare_datasets
from dr4sr_tpu_torch.data.loader import BatchIterator
from dr4sr_tpu_torch.meta import hypergrad
from dr4sr_tpu_torch.models.metamodel import gumbel_softmax_weight
from dr4sr_tpu_torch.modules.layers import MLP
from dr4sr_tpu_torch.ops import attention
from dr4sr_tpu_torch.utils.reparam import flat_param_count, flatten_params, functional_apply


def _t(x):
    return torch.tensor(np.asarray(x))


def test_hypergradient_matches_closed_form():
    """L_train(w, φ) = ½wᵀAw − φᵀw and L_val(w) = bᵀw: the iteration gives
    hyper_grad = Σ_{i=0..k} (I − lr·A)^i · b (tests/test_meta.py's case)."""
    rng = np.random.default_rng(0)
    d, lr, k = 5, 0.05, 3
    m = rng.normal(size=(d, d))
    a = torch.tensor(m @ m.T / d + np.eye(d))
    b = torch.tensor(rng.normal(size=d))
    w = torch.tensor(rng.normal(size=d), requires_grad=True)
    phi = torch.tensor(rng.normal(size=d), requires_grad=True)
    hg = hypergrad.hypergradient(lambda p, q: 0.5 * p["w"] @ a @ p["w"] - q["phi"] @ p["w"],
                                 lambda p: b @ p["w"], {"w": w}, {"phi": phi}, lr=lr,
                                 truncate_iter=k)
    ima = np.eye(d) - lr * a.numpy()
    p = v = b.numpy()
    for _ in range(k):
        v = ima @ v
        p = p + v
    np.testing.assert_allclose(hg["phi"].numpy(), p, rtol=1e-5)
    assert w.grad is None and phi.grad is None  # nothing accumulated


def _nonlinear(lib):
    """A small bilevel problem with a nonlinear train loss in W and φ, written
    once for each library: train(W, φ), val(W)."""
    rng = np.random.default_rng(1)
    x = rng.normal(size=(7, 5)).astype(np.float32)
    x2 = rng.normal(size=(4, 5)).astype(np.float32)
    if lib == "jax":
        softplus, sigmoid, tanh, arr = jax.nn.softplus, jax.nn.sigmoid, jnp.tanh, jnp.asarray
    else:
        softplus, sigmoid, tanh, arr = (torch.nn.functional.softplus, torch.sigmoid, torch.tanh,
                                        torch.from_numpy)
    x, x2 = arr(x), arr(x2)

    def train(p, m):
        h = softplus(x @ p["a"] + p["b"])  # [7, 3]
        gate = sigmoid(x @ m["s"])[:, None]  # [7, 1]
        return (gate * h * h).sum() + m["t"] ** 2 * (p["a"] ** 2).sum()

    def val(p):
        return tanh(x2 @ p["a"] + p["b"]).sum()

    return train, val


def test_hypergradient_matches_jax():
    rng = np.random.default_rng(2)
    params = {"a": rng.normal(size=(5, 3)).astype(np.float32),
              "b": rng.normal(size=3).astype(np.float32)}
    meta = {"s": rng.normal(size=5).astype(np.float32), "t": np.float32(0.7)}
    train, val = _nonlinear("jax")
    want = jax_hg.hypergradient(train, val, {k: jnp.asarray(v) for k, v in params.items()},
                                {k: jnp.asarray(v) for k, v in meta.items()}, lr=0.1,
                                truncate_iter=3)
    train, val = _nonlinear("torch")
    got = hypergrad.hypergradient(train, val,
                                  {k: _t(v).requires_grad_() for k, v in params.items()},
                                  {k: _t(v).requires_grad_() for k, v in meta.items()},
                                  lr=0.1, truncate_iter=3)
    assert sorted(got) == sorted(meta)
    for k in meta:
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]), rtol=1e-4, atol=1e-7,
                                   err_msg=k)


@pytest.mark.parametrize("scale", [10.0, 0.01])
def test_clip_by_global_norm_matches_jax(scale):
    rng = np.random.default_rng(3)
    tree = {"a": (scale * rng.normal(size=(4, 3))).astype(np.float32),
            "b": (scale * rng.normal(size=2)).astype(np.float32)}
    want = jax_hg.clip_by_global_norm({k: jnp.asarray(v) for k, v in tree.items()}, 1.0)
    got = hypergrad.clip_by_global_norm({k: _t(v) for k, v in tree.items()}, 1.0)
    for k in tree:
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]), rtol=1e-6, err_msg=k)
    norm = hypergrad.tree_global_norm(got).item()
    assert norm == pytest.approx(1.0, rel=1e-5) if scale > 1 else norm < 1.0


@pytest.mark.parametrize("with_noise", [True, False])
def test_gumbel_softmax_weight_matches_jax(with_noise):
    rng = np.random.default_rng(4)
    logits = rng.normal(size=(3, 6, 2)).astype(np.float32)
    tau = np.float32(2.5)
    key = jax.random.PRNGKey(5) if with_noise else None
    want = jax_gumbel_softmax_weight(jnp.asarray(logits), jnp.asarray(tau), key)
    noise = _t(jax.random.gumbel(key, logits.shape)) if with_noise else None
    got = gumbel_softmax_weight(_t(logits), _t(tau), noise)
    assert got.shape == (3, 6)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-6)


@pytest.mark.parametrize("hard", [False, True])
def test_gumbel_topk_relaxation_matches_jax(hard):
    rng = np.random.default_rng(6)
    scores = rng.normal(size=(4, 9)).astype(np.float32)
    weights = rng.normal(size=(4, 9)).astype(np.float32)
    key = jax.random.PRNGKey(7)

    def jax_obj(s):
        khot = jax_hg.gumbel_topk_relaxation(key, s, 3, tau=0.5, hard=hard)
        return (khot * weights).sum(), khot

    (_, want), want_grad = jax.value_and_grad(jax_obj, has_aux=True)(jnp.asarray(scores))
    s = _t(scores).requires_grad_()
    got = hypergrad.gumbel_topk_relaxation(s, 3, tau=0.5, hard=hard,
                                           noise=_t(jax.random.gumbel(key, scores.shape)))
    (got * _t(weights)).sum().backward()
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), atol=1e-6)
    # the gradient passes back through k softmaxes at τ = 0.5: f32 atol 1e-5
    np.testing.assert_allclose(s.grad.numpy(), np.asarray(want_grad), atol=1e-5)
    if hard:
        assert set(np.unique(got.detach().numpy())) == {0.0, 1.0}
        assert (got.detach().sum(-1) == 3).all()


def test_reparam_count_and_round_trip():
    jax_mlp = JaxMLP((16, 2))
    jax_params = jax_mlp.init(jax.random.PRNGKey(0), jnp.zeros((1, 16)))["params"]
    module = MLP(16, (16, 2), generator=torch.Generator().manual_seed(0))
    assert flat_param_count(module) == jax_flat_param_count(jax_params) == 16 * 16 + 16 + 34
    flat, unravel = flatten_params(module)
    assert flat.shape == (flat_param_count(module),)
    for name, p in module.named_parameters():
        assert torch.equal(unravel(flat)[name], p)
    x = torch.randn(5, 16, generator=torch.Generator().manual_seed(1))
    torch.testing.assert_close(functional_apply(module, unravel, flat, x), module(x),
                               rtol=0, atol=0)
    doubled = {k: 2 * v for k, v in module.state_dict().items()}
    flat2, _ = flatten_params(doubled)  # a dict of tensors flattens alike
    assert flat_param_count(doubled) == flat.numel()
    torch.testing.assert_close(flat2, 2 * flat, rtol=0, atol=0)
    with torch.no_grad():
        for p in module.parameters():
            p.mul_(2)
    torch.testing.assert_close(functional_apply(module, unravel, flat2, x), module(x))
    with pytest.raises(ValueError, match="flat vector"):
        unravel(flat[:-1])


def test_meta_params_from_jax_carries_the_mlp_and_tau():
    jax_mlp = JaxMLP((16, 2))
    jax_params = jax_mlp.init(jax.random.PRNGKey(3), jnp.zeros((1, 16)))["params"]
    meta = jax.tree_util.tree_map(np.asarray, {"mlp": jax_params, "tau": jnp.ones(()) * 4.5})
    module = MLP(16, (16, 2))
    state, tau = meta_params_from_jax(meta, module)
    module.load_state_dict(state)
    x = np.random.default_rng(0).normal(size=(6, 16)).astype(np.float32)
    want = jax_mlp.apply({"params": jax_params}, jnp.asarray(x))
    np.testing.assert_allclose(module(_t(x)).detach().numpy(), np.asarray(want), atol=1e-6)
    assert tau == 4.5


@pytest.fixture(scope="module")
def rows(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("meta_rows"))
    jax_write(root, num_users=50, num_items=30, max_seq_len=10, seed=1)
    cfg = jax_synthetic_config(max_seq_len=10)
    return (jax_prepare_datasets(cfg, root=root)[0].rows(),
            prepare_datasets(cfg, root=root)[0].rows())


@pytest.mark.parametrize("batch_size", [8, 80])  # 80 > the 50 train rows: padded
def test_sample_batch_equals_jax(rows, batch_size):
    jax_rows, port_rows = rows
    jax_it = JaxBatchIterator(jax_rows, batch_size, seed=4099)
    port_it = BatchIterator(port_rows, batch_size, seed=4099)

    def draws(it):
        out = [it.sample_batch(), it.sample_batch(3)]
        out += list(it)  # an epoch in between draws from the same generator
        return out + [it.sample_batch()]

    got, want = draws(port_it), draws(jax_it)
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert sorted(g) == sorted(w)
        for key in g:
            np.testing.assert_array_equal(g[key], w[key], err_msg=key)
    if batch_size > len(port_rows):
        assert got[0]["valid"].sum() == len(port_rows) and not got[0]["valid"].all()


def test_flash_attention_refuses_a_second_derivative():
    """Its backward's gradients would be constants to a second derivative
    (the CUDA kernels' are, having no autograd graph), so a backward that
    builds a graph (``create_graph=True``) raises; the plain route
    differentiates twice. A projection in front, as in the encoder, shows
    why raising is needed: a Hessian-vector product of its weight does not
    reach an error node that ``once_differentiable`` would leave."""
    gen = torch.Generator().manual_seed(0)
    x = torch.randn(2, 5, 32, generator=gen)
    w = (0.1 * torch.randn(32, 96, generator=gen)).requires_grad_()

    def loss(attend):
        q, k, v = (x @ w).reshape(2, 5, 3, 2, 16).permute(2, 0, 3, 1, 4).contiguous()
        out = attend(q, k, v)
        return (out * out).sum()

    flash = loss(lambda q, k, v: attention.FlashAttention.apply(q, k, v, None, True))
    (g,) = torch.autograd.grad(flash, w, retain_graph=True)  # first order: fine
    with pytest.raises(RuntimeError, match="plain_attention"):
        torch.autograd.grad(flash, w, create_graph=True)
    plain = loss(lambda q, k, v: attention.mha_reference(q, k, v, None, True))
    (g_plain,) = torch.autograd.grad(plain, w, create_graph=True)
    torch.testing.assert_close(g_plain, g, rtol=1e-5, atol=1e-5)
    (hv,) = torch.autograd.grad(g_plain, w, torch.ones_like(w))
    assert torch.isfinite(hv).all() and hv.abs().max() > 0


def test_plain_attention_routes_and_restores():
    """Tensors on the 'meta' device stand in for CUDA ones: no route for them
    outside the context, the plain route inside it."""
    q = torch.empty(2, 2, 5, 16, device="meta")
    with pytest.raises(ValueError, match="no attention route"):
        attention.multihead_attention(q, q, q)
    with attention.plain_attention():
        assert attention.multihead_attention(q, q, q).shape == q.shape
        with attention.plain_attention():
            pass
        assert attention.multihead_attention(q, q, q).shape == q.shape  # nested exit keeps it
    with pytest.raises(ValueError, match="no attention route"):
        attention.multihead_attention(q, q, q)
    with pytest.raises(KeyError):
        with attention.plain_attention():
            raise KeyError("inside")
    with pytest.raises(ValueError, match="no attention route"):
        attention.multihead_attention(q, q, q)  # restored after the exception
