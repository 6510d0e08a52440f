"""The port's regenerator (``dr4sr_tpu_torch.regen.generator``) against the
JAX package's, weights carried over by ``convert.generator_params_from_jax``.

Small width (vocab 42, D = 32, 2 heads, 2 layers, K = 3), dropout off:

* logits and condition probabilities in eval mode, atol 2e-5;
* ``generator_loss`` atol 2e-5, and every parameter's gradient against
  ``jax.grad`` within 2e-5 of that parameter's largest gradient, with the
  same gumbel draw fed to both (``jax.random.gumbel`` patched to return it);

and at full width from the committed trained toys regenerator
(``artifacts/regenerator_toys_a5b2K5ew1p0.msgpack``, 11,925 items, K = 5),
loaded by the port's own reader: logits on 8 sources, atol 1e-4.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dr4sr_tpu.regen import generator as jax_gen
from dr4sr_tpu_torch.convert import generator_params_from_jax
from dr4sr_tpu_torch.data.synthetic import markov_sequences
from dr4sr_tpu_torch.regen.generator import Generator, frame_pairs, generator_loss
from dr4sr_tpu_torch.train.checkpoint import load_jax_checkpoint, load_regenerator
from torch_one_thread import one_torch_thread  # noqa: F401  (autouse)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ARTIFACT = os.path.join(REPO, "artifacts", "regenerator_toys_a5b2K5ew1p0.msgpack")
NUM_ITEMS, K, D = 40, 3, 32
ATOL = 2e-5
GRAD_RTOL = 2e-5
WIDTHS = dict(k=K, embed_dim=D, num_heads=2, num_layers=2, ffn_dim=64, dropout=0.0)


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def small_pairs(seed, n=6, num_items=NUM_ITEMS):
    """(sequence, subsequence) pairs from Markov sequences, one source longer
    than the frame (truncated) and one target that fills it. Targets are
    drawn from the framed part of their source, as mined patterns are."""
    rng = np.random.default_rng(seed)
    seqs = markov_sequences(num_users=n, num_items=num_items, min_len=3, max_len=14, seed=seed)
    seqs[0] = [int(x) for x in rng.integers(1, num_items, size=60)]
    pairs = []
    for s in seqs:
        framed = s[:50]
        keep = np.sort(rng.choice(len(framed), size=min(len(framed), int(rng.integers(2, 6))),
                                  replace=False))
        pairs.append((s, [framed[i] for i in keep]))
    pairs[1] = (pairs[1][0], [pairs[1][0][i] for i in rng.integers(0, len(pairs[1][0]), size=30)])
    return pairs


def pair_models(seed, **widths):
    """(JAX Generator, its params, the port's Generator with those weights, batch)."""
    widths = {**WIDTHS, **widths}
    data = frame_pairs(small_pairs(seed), NUM_ITEMS)
    g = jax_gen.Generator(num_items=NUM_ITEMS, **widths)
    rng = jax.random.PRNGKey(seed)
    params = g.init({"params": rng, "dropout": rng, "gumbel": rng}, jnp.asarray(data["src"]),
                    jnp.asarray(data["tgt"][:, :-1]), jnp.asarray(data["tgt_len"]),
                    jnp.asarray(1.0))["params"]
    # at init (normal 0.02) the condition logits are ~0: the probabilities
    # are uniform and their gradients are differences of nearly equal terms,
    # so give the condition MLP trained-like weights (numpy, seeded)
    draw = np.random.default_rng(100 + seed)
    params = jax.tree_util.tree_map(lambda a: a, params)  # a mutable copy
    for dense in params["condition_encoder"]["condition_layer"].values():
        dense["kernel"] = jnp.asarray(draw.normal(0, 0.3, size=dense["kernel"].shape), jnp.float32)
    module = Generator(NUM_ITEMS, **widths)
    module.load_state_dict(generator_params_from_jax(_np(params), module))
    return g, params, module, data


def test_frame_pairs_matches_jax():
    pairs = small_pairs(0)
    want = jax_gen.frame_pairs(pairs, NUM_ITEMS)
    got = frame_pairs(pairs, NUM_ITEMS)
    assert set(got) == set(want)
    for key in want:
        np.testing.assert_array_equal(got[key], want[key])
        assert got[key].dtype == want[key].dtype


def test_init_semantics():
    g = torch.Generator().manual_seed(0)
    module = Generator(NUM_ITEMS, generator=g, **WIDTHS)
    table = module.item_embedding.weight
    assert table.shape == (NUM_ITEMS + 2, D) and (table[0] == 0).all()
    assert table.requires_grad  # the PAD row is zeroed, not frozen
    assert abs(table[1:].std().item() - 0.02) < 0.004
    assert module.sos == NUM_ITEMS and module.eos == NUM_ITEMS + 1


@pytest.mark.parametrize("tau", [1.0, 0.3])
def test_eval_logits_and_conditions_match_jax(tau):
    g, params, module, data = pair_models(1)
    src, tgt_in, tgt_len = data["src"], data["tgt"][:, :-1], data["tgt_len"]
    want_logits, want_cond = g.apply({"params": params}, jnp.asarray(src), jnp.asarray(tgt_in),
                                     jnp.asarray(tgt_len), jnp.asarray(tau), training=False)
    with torch.no_grad():
        logits, cond = module.eval()(*(torch.from_numpy(a).long() for a in (src, tgt_in, tgt_len)),
                                     tau)
    assert logits.shape == (len(src), tgt_in.shape[1], NUM_ITEMS + 2)
    np.testing.assert_allclose(logits.numpy(), np.asarray(want_logits), atol=ATOL)
    np.testing.assert_allclose(cond.numpy(), np.asarray(want_cond), atol=ATOL)
    # only the source's tokens keep a logit
    keep = np.zeros((len(src), NUM_ITEMS + 2), bool)
    keep[np.arange(len(src))[:, None], src] = True
    assert ((logits.numpy() > -1e29) == keep[:, None, :]).all()


def _flat_grads(module, grads_tree):
    return generator_params_from_jax(_np(grads_tree), module)


@pytest.mark.parametrize("training", [False, True], ids=["eval", "gumbel"])
def test_loss_and_gradients_match_jax_grad(training, monkeypatch):
    g, params, module, data = pair_models(2)
    src, tgt, tgt_len = data["src"], data["tgt"], data["tgt_len"]
    tau = 0.7
    noise = np.random.default_rng(3).gumbel(size=(len(src), K)).astype(np.float32)
    monkeypatch.setattr(jax.random, "gumbel", lambda key, shape, *a, **kw: jnp.asarray(noise))
    rng = jax.random.PRNGKey(0)

    def loss_fn(p):
        logits, cond = g.apply({"params": p}, jnp.asarray(src), jnp.asarray(tgt[:, :-1]),
                               jnp.asarray(tgt_len), jnp.asarray(tau), training=training,
                               rngs={"dropout": rng, "gumbel": rng})
        return jax_gen.generator_loss(logits, jnp.asarray(tgt[:, 1:]), cond, 0.5)

    (want_loss, want_aux), want_grads = jax.value_and_grad(loss_fn, has_aux=True)(params)
    module.train(training)
    s, t, n = (torch.from_numpy(a).long() for a in (src, tgt, tgt_len))
    logits, cond = module(s, t[:, :-1], n, tau, gumbel=torch.from_numpy(noise))
    loss, aux = generator_loss(logits, t[:, 1:], cond, 0.5)
    loss.backward()
    np.testing.assert_allclose(loss.item(), float(want_loss), atol=ATOL)
    for key in ("ce", "entropy"):
        np.testing.assert_allclose(aux[key].item(), float(want_aux[key]), atol=ATOL)
    want = _flat_grads(module, want_grads)
    got = dict(module.named_parameters())
    assert set(want) == set(got)
    for name, w in want.items():
        err = (got[name].grad - w).abs().max().item()
        assert err <= GRAD_RTOL * w.abs().max().item(), (name, err, w.abs().max().item())


def test_gumbel_noise_comes_from_the_callers_generator():
    _, _, module, data = pair_models(4)
    s, t, n = (torch.from_numpy(data[k]).long() for k in ("src", "tgt", "tgt_len"))
    module.train()
    runs = [module(s, t[:, :-1], n, 1.0, generator=torch.Generator().manual_seed(seed))[1]
            for seed in (5, 5, 6)]
    torch.testing.assert_close(runs[0], runs[1], rtol=0, atol=0)
    assert not torch.equal(runs[0], runs[2])


@pytest.fixture(scope="module")
def artifact():
    params = load_jax_checkpoint(ARTIFACT)["params"]
    return params, load_regenerator(ARTIFACT, device="cpu")


def test_artifact_loads_at_full_width(artifact):
    _, module = artifact
    assert module.widths() == {"num_items": 11925, "k": 5, "embed_dim": 64, "num_heads": 2,
                               "num_layers": 2, "ffn_dim": 256, "max_len": 64}
    assert not module.training


def test_load_regenerator_defaults_to_the_card(monkeypatch):
    """Like every entry point of the port, the loader goes to the card
    unless the caller asks for the CPU, and raises without CUDA."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        load_regenerator(ARTIFACT)


def test_artifact_logits_match_jax(artifact):
    params, module = artifact
    n = module.num_items
    seqs = markov_sequences(num_users=8, num_items=n, min_len=5, max_len=40, seed=7)
    pairs = [(s, s[::3]) for s in seqs]
    data = frame_pairs(pairs, n)
    g = jax_gen.Generator(num_items=n, k=5)
    args = [jnp.asarray(data["src"]), jnp.asarray(data["tgt"][:, :-1]),
            jnp.asarray(data["tgt_len"]), jnp.asarray(0.5)]
    want_logits, want_cond = g.apply({"params": jax.tree_util.tree_map(jnp.asarray, params)},
                                     *args, training=False)
    s, t, tl = (torch.from_numpy(data[k]).long() for k in ("src", "tgt", "tgt_len"))
    with torch.no_grad():
        logits, cond = module(s, t[:, :-1], tl, 0.5)
    np.testing.assert_allclose(logits.numpy(), np.asarray(want_logits), atol=1e-4)
    np.testing.assert_allclose(cond.numpy(), np.asarray(want_cond), atol=1e-4)
