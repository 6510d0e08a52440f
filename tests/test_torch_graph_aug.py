"""``modules/graph_augmentation.py`` and ``modules/vq.py`` in the port
against the JAX package, function by function. ``jax.random`` and torch draw
different streams, so JAX's draws (Bernoulli masks, uniforms, k-means
initial rows, augmentation draws) are reproduced from its keys and fed in.
Values within atol 1e-5, gradients within 1e-5 of the largest; k-means
assignments, top-1 items and augmented sequences exactly.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch_zoo_parity import jax_aug_draws

from dr4sr_tpu.modules import graph_augmentation as jga
from dr4sr_tpu.modules import vq as jvq
from dr4sr_tpu.modules.augmentation import augment as jax_augment
from dr4sr_tpu_torch.convert import params_from_jax
from dr4sr_tpu_torch.modules import graph_augmentation as ga
from dr4sr_tpu_torch.modules import vq
from dr4sr_tpu_torch.modules.augmentation import apply_draws

ATOL = 1e-5
N, D, E = 40, 8, 160


def _t(a):
    return torch.from_numpy(np.array(a))


def _graph(seed=0):
    rng = np.random.default_rng(seed)
    row = rng.integers(0, N, E).astype(np.int32)
    col = rng.integers(0, N, E).astype(np.int32)
    w = rng.random(E).astype(np.float32)
    return (jga.Graph(jnp.asarray(row), jnp.asarray(col), jnp.asarray(w), N),
            ga.Graph(_t(row).long(), _t(col).long(), _t(w), N))


def _emb(seed=1, n=N):
    return np.random.default_rng(seed).standard_normal((n, D)).astype(np.float32)


def _close(got, want, atol=ATOL):
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), atol=atol)


def _grad_close(got, want):
    want = np.asarray(want)
    np.testing.assert_allclose(got.numpy(), want, atol=ATOL * max(np.abs(want).max(), 1e-30))


# ------------------------------------------------------------------ k-means


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_kmeans_from_jax_initial_rows_equals_jax(seed):
    # clustered data: 6 blobs, 5 centroids, so some clusters share a blob
    rng = np.random.default_rng(seed)
    x = (rng.standard_normal((6, D))[rng.integers(0, 6, 300)]
         + 0.3 * rng.standard_normal((300, D))).astype(np.float32)
    key = jax.random.PRNGKey(seed)
    want_c, want_a = jga.kmeans(key, jnp.asarray(x), 5, 20)
    init = jax.random.choice(key, 300, shape=(5,), replace=False)
    got_c, got_a = ga.kmeans(_t(x), 5, _t(init).long(), 20)
    _close(got_c, want_c)
    np.testing.assert_array_equal(got_a.numpy(), np.asarray(want_a))


def test_kmeans_empty_cluster_keeps_its_centroid():
    # two equal initial centroids: ties go to the first, the second is empty
    x = torch.tensor([[0.0, 0.0], [0.0, 0.0], [5.0, 5.0], [5.0, 4.0]])
    cents, assign = ga.kmeans(x, 3, torch.tensor([0, 1, 2]), iters=3)
    _close(cents, [[0.0, 0.0], [0.0, 0.0], [5.0, 4.5]])
    np.testing.assert_array_equal(assign.numpy(), [0, 0, 2, 2])


def test_kmeans_init_draws_distinct_rows_from_the_seed():
    a, b = ga.kmeans_init(50, 7, 3), ga.kmeans_init(50, 7, 3)
    assert torch.equal(a, b) and len(set(a.tolist())) == 7 and int(a.max()) < 50
    assert not torch.equal(a, ga.kmeans_init(50, 7, 4))


def test_fit_prototypes_equals_jax():
    x = _emb(3, 120)
    x[0] = 0.0  # the PAD row: left out of the fit, assigned all the same
    key = jax.random.PRNGKey(5)
    want = jga.fit_prototypes(key, jnp.asarray(x), 6)
    init = jax.random.choice(key, 119, shape=(6,), replace=False)
    got = ga.fit_prototypes(_t(x), 6, _t(init).long())
    _close(got.centroids, want.centroids)
    np.testing.assert_array_equal(got.assign.numpy(), np.asarray(want.assign))
    assert got.assign.shape == (120,)


# -------------------------------------------------------------- propagation


@pytest.mark.parametrize("kind", ["edge", "node"])
def test_dropout_from_jax_masks_equals_jax(kind):
    jg, tg = _graph()
    key = jax.random.PRNGKey(2)
    if kind == "edge":
        want = jga.edge_dropout(key, jg, 0.3)
        got = ga.edge_dropout(tg, 0.3, _t(jax.random.bernoulli(key, 0.7, (E,))))
    else:
        want = jga.node_dropout(key, jg, 0.3)
        got = ga.node_dropout(tg, 0.3, _t(jax.random.bernoulli(key, 0.7, (N,))))
    _close(got.weight, want.weight)
    assert got.weight.shape == (E,) and (got.weight == 0).any()


def test_sample_keep_rate():
    keep = ga.sample_keep(torch.Generator().manual_seed(0), 20000, 0.1, "cpu")
    assert keep.dtype == torch.bool and abs(keep.float().mean().item() - 0.9) < 0.01


def _jax_noise(key, layers):
    """SimGCL's per-layer uniforms as ``propagate_mean`` draws them."""
    out = []
    for _ in range(layers):
        key, r = jax.random.split(key)
        out.append(np.asarray(jax.random.uniform(r, (N, D))))
    return _t(np.stack(out))


@pytest.mark.parametrize("noisy", [False, True])
@pytest.mark.parametrize("layers", [1, 3])
def test_propagate_mean_equals_jax(noisy, layers):
    jg, tg = _graph(4)
    x = _emb(5)
    key = jax.random.PRNGKey(9)
    cot = np.random.default_rng(6).standard_normal((N, D)).astype(np.float32)
    kw = dict(noise_rng=key, noise_eps=0.1) if noisy else {}
    want, vjp = jax.vjp(lambda e: jga.propagate_mean(jg, e, layers, **kw), jnp.asarray(x))
    leaf = _t(x).requires_grad_()
    got = ga.propagate_mean(tg, leaf, layers,
                            **(dict(noise=_jax_noise(key, layers), noise_eps=0.1) if noisy else {}))
    got.backward(_t(cot))
    _close(got, want)
    _grad_close(leaf.grad, vjp(jnp.asarray(cot))[0])


def test_propagate_layers_equals_jax():
    jg, tg = _graph(7)
    x = _emb(8)
    want = jga.propagate_layers(jg, jnp.asarray(x), 3)
    got = ga.propagate_layers(tg, _t(x), 3)
    assert len(got) == 4
    for g, w in zip(got, want):
        _close(g, w)


def test_info_nce_all_equals_jax():
    rng = np.random.default_rng(10)
    a, b = rng.standard_normal((2, 12, D)).astype(np.float32)
    all_reps = _emb(11)
    fn = lambda a, b, c: jga.info_nce_all(a, b, c, 0.2)  # noqa: E731
    want, grads = jax.value_and_grad(fn, argnums=(0, 1, 2))(
        jnp.asarray(a), jnp.asarray(b), jnp.asarray(all_reps))
    leaves = [_t(v).requires_grad_() for v in (a, b, all_reps)]
    got = ga.info_nce_all(*leaves, 0.2)
    got.backward()
    _close(got, want)
    for leaf, g in zip(leaves, grads):
        _grad_close(leaf.grad, g)


# ------------------------------------------------------- user-item functions

NUM_USERS = 15  # nodes 0..14 are users, 15..39 items (24 of them past PAD)


def _ids(seed):
    rng = np.random.default_rng(seed)
    return rng.integers(1, NUM_USERS, 6), rng.integers(1, N - NUM_USERS, 6)


@pytest.mark.parametrize("aug_type", ["ED", "ND"])
def test_sgl_cl_loss_from_jax_masks_equals_jax(aug_type):
    jg, tg = _graph(12)
    x = _emb(13)
    users, items = _ids(14)
    key = jax.random.PRNGKey(15)
    want, want_g = jax.value_and_grad(lambda e: jga.sgl_cl_loss(
        key, jg, e, NUM_USERS, jnp.asarray(users), jnp.asarray(items), 2, aug_type, 0.2))(
        jnp.asarray(x))
    size = E if aug_type == "ED" else N
    keep = [_t(jax.random.bernoulli(r, 0.8, (size,))) for r in jax.random.split(key)]
    leaf = _t(x).requires_grad_()
    got = ga.sgl_cl_loss(tg, leaf, NUM_USERS, _t(users), _t(items), keep, 2, aug_type, 0.2)
    got.backward()
    _close(got, want)
    _grad_close(leaf.grad, want_g)


def test_simgcl_cl_loss_from_jax_noise_equals_jax():
    jg, tg = _graph(16)
    x = _emb(17)
    users, items = _ids(18)
    key = jax.random.PRNGKey(19)
    want, want_g = jax.value_and_grad(lambda e: jga.simgcl_cl_loss(
        key, jg, e, NUM_USERS, jnp.asarray(users), jnp.asarray(items), 2, 0.1))(jnp.asarray(x))
    noise = [_jax_noise(r, 2) for r in jax.random.split(key)]
    leaf = _t(x).requires_grad_()
    got = ga.simgcl_cl_loss(tg, leaf, NUM_USERS, _t(users), _t(items), noise, 2, 0.1)
    got.backward()
    _close(got, want)
    _grad_close(leaf.grad, want_g)


def test_ncl_cl_losses_equal_jax():
    jg, tg = _graph(20)
    x = _emb(21)
    users, items = _ids(22)
    protos = []
    for seed, n in ((23, NUM_USERS), (24, N - NUM_USERS)):
        rng = np.random.default_rng(seed)
        protos.append((rng.standard_normal((4, D)).astype(np.float32),
                       rng.integers(0, 4, n).astype(np.int32)))

    def jax_fn(e):
        out = jga.ncl_cl_losses(jga.propagate_layers(jg, e, 2), NUM_USERS, jnp.asarray(users),
                                jnp.asarray(items),
                                *[jga.KMeansState(jnp.asarray(c), jnp.asarray(a))
                                  for c, a in protos], hyper_layers=1, alpha=0.7)
        return out["structure_cl_loss"] + 2.0 * out["semantic_cl_loss"], out

    (_, want), want_g = jax.value_and_grad(jax_fn, has_aux=True)(jnp.asarray(x))
    leaf = _t(x).requires_grad_()
    got = ga.ncl_cl_losses(ga.propagate_layers(tg, leaf, 2), NUM_USERS, _t(users), _t(items),
                           *[ga.KMeansState(_t(c), _t(a).long()) for c, a in protos],
                           hyper_layers=1, alpha=0.7)
    (got["structure_cl_loss"] + 2.0 * got["semantic_cl_loss"]).backward()
    for name in want:
        _close(got[name], want[name])
    _grad_close(leaf.grad, want_g)


# ------------------------------------------------------------------ ICLRec

L, ITEMS = 10, 30


def _seqs(seed, b=24):
    rng = np.random.default_rng(seed)
    seqlen = rng.integers(1, L + 1, size=b).astype(np.int32)
    seqlen[:2] = (1, L)
    seq = np.where(np.arange(L)[None, :] < seqlen[:, None],
                   rng.integers(1, ITEMS, size=(b, L)), 0).astype(np.int32)
    return seq, seqlen


@pytest.mark.parametrize("kind", ["item_crop", "item_mask", "item_reorder", "item_random"])
def test_iclrec_cl_losses_from_jax_draws_equal_jax(kind):
    """A toy encoder (an embedding lookup scaled by a position weight) stands
    for SASRec; the views come from JAX's keys, the intents from fixed
    centroids; the pooled reps come from another table, which takes no
    gradient on either side."""
    seq, seqlen = _seqs(30)
    rng = np.random.default_rng(31)
    table = rng.standard_normal((ITEMS + 1, D)).astype(np.float32)
    pos_w = rng.standard_normal((L, 1)).astype(np.float32)
    pooled = rng.standard_normal((len(seq), D)).astype(np.float32)
    cents = rng.standard_normal((3, D)).astype(np.float32)
    valid = np.arange(len(seq)) % 7 != 3
    key = jax.random.PRNGKey(32)

    def jax_fn(t, p):
        out = jga.iclrec_cl_losses(
            key, lambda s, n, r: t[s] * p, jnp.asarray(seq), jnp.asarray(seqlen),
            jnp.asarray(pooled), jga.KMeansState(jnp.asarray(cents), jnp.zeros(3, jnp.int32)),
            ITEMS, aug_kind=kind, temperature=0.5, valid=jnp.asarray(valid))
        return out["instance_cl_loss"] + 0.3 * out["intent_cl_loss"], out

    (_, want), want_g = jax.value_and_grad(jax_fn, argnums=(0, 1), has_aux=True)(
        jnp.asarray(table), jnp.asarray(pos_w))
    r_i, r_j, _, _ = jax.random.split(key, 4)
    views = [jax_aug_draws(kind, r, seqlen, L) for r in (r_i, r_j)]
    t, p = _t(table).requires_grad_(), _t(pos_w).requires_grad_()
    got = ga.iclrec_cl_losses(lambda s, n: t[s] * p, _t(seq).long(), _t(seqlen).long(),
                              _t(pooled), ga.KMeansState(_t(cents), None), ITEMS, views,
                              temperature=0.5, valid=_t(valid))
    (got["instance_cl_loss"] + 0.3 * got["intent_cl_loss"]).backward()
    for name in want:
        _close(got[name], want[name])
    _grad_close(t.grad, want_g[0])
    _grad_close(p.grad, want_g[1])
    # the views really are JAX's
    want_seq = jax_augment(r_i, jnp.asarray(seq), jnp.asarray(seqlen), kind, mask_id=ITEMS)[0]
    np.testing.assert_array_equal(
        apply_draws(_t(seq).long(), _t(seqlen).long(), views[0], mask_id=ITEMS)[0].numpy(),
        np.asarray(want_seq))


# ------------------------------------------- similarity-driven augmentations


def test_online_top1_similar_equals_jax():
    table = _emb(40, ITEMS + 1)
    ids = np.random.default_rng(41).integers(1, ITEMS + 1, (5, 7))
    want = jga.online_top1_similar(jnp.asarray(table), jnp.asarray(ids))
    got = ga.online_top1_similar(_t(table), _t(ids))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert not (got == _t(ids)).any()  # never the item itself


@pytest.mark.parametrize("fn,rate", [("item_substitute", 0.3), ("item_insert", 0.4),
                                     ("item_insert", 1.0)])
def test_similarity_augmentations_from_jax_uniforms_equal_jax(fn, rate):
    seq, seqlen = _seqs(42)
    table = _emb(43, ITEMS + 1)
    key = jax.random.PRNGKey(44)
    want_seq, want_len = getattr(jga, fn)(key, jnp.asarray(seq), jnp.asarray(seqlen),
                                          jnp.asarray(table), rate)
    u = _t(jax.random.uniform(key, seq.shape))
    got_seq, got_len = getattr(ga, fn)(_t(seq).long(), _t(seqlen).long(), _t(table), u, rate)
    np.testing.assert_array_equal(got_seq.numpy(), np.asarray(want_seq))
    np.testing.assert_array_equal(got_len.numpy(), np.asarray(want_len))
    if fn == "item_insert":
        full = seqlen + np.maximum(1, (rate * seqlen).astype(np.int32)) > L
        assert full.any()  # some rows overflow L and are truncated from the left
        assert (got_len.numpy()[full] == L).all()


# ---------------------------------------------------------------------- VQ


@pytest.mark.parametrize("levels", [None, 1, 3])
def test_vector_quantizers_equal_jax(levels):
    """Outputs, codes and loss from the same codebooks, and the
    straight-through gradients to the input and the codebooks."""
    x = np.random.default_rng(50).standard_normal((4, 6, D)).astype(np.float32) * 0.05
    cot = np.random.default_rng(51).standard_normal(x.shape).astype(np.float32)
    if levels is None:
        jmod = jvq.VanillaVectorQuantizer(16, D)
        module = vq.VanillaVectorQuantizer(16, D)
    else:
        jmod = jvq.VectorQuantizer(16, D, num_levels=levels)
        module = vq.VectorQuantizer(16, D, num_levels=levels)
    params = jmod.init(jax.random.PRNGKey(52), jnp.asarray(x))["params"]
    module.load_state_dict(params_from_jax(jax.tree_util.tree_map(np.asarray, params), module))

    def jax_fn(p, xx):
        q, c, loss = jmod.apply({"params": p}, xx)
        return jnp.sum(q * cot) + loss, (q, c, loss)

    (_, (want_q, want_c, want_loss)), (want_gp, want_gx) = jax.value_and_grad(
        jax_fn, argnums=(0, 1), has_aux=True)(params, jnp.asarray(x))
    leaf = _t(x).requires_grad_()
    q, c, loss = module(leaf)
    ((q * _t(cot)).sum() + loss).backward()
    _close(q, want_q)
    np.testing.assert_array_equal(c.numpy(), np.asarray(want_c))
    _close(loss, want_loss)
    _grad_close(leaf.grad, want_gx)
    want_gp = params_from_jax(jax.tree_util.tree_map(np.asarray, want_gp), module)
    for name, p in module.named_parameters():
        _grad_close(p.grad, want_gp[name].numpy())
