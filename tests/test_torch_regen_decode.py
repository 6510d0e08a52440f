"""The port's batched decode (``dr4sr_tpu_torch.regen.decode``) against the
JAX package's: tokens must be equal.

* Small width (vocab 42, D = 32, K = 3): the full-buffer greedy, the
  KV-cached greedy and the beam search (W = 1 and W = 3), at γ = 0 and at
  γ = 0.5 with JAX's per-step uniform draws fed to the port; the sources
  include an all-zero row (a padded lane: fully masked attention), a
  one-item source and a source with repeats.
* The committed trained toys regenerator, at full width: ``decode_dataset``
  of 32 synthetic sources under all 5 conditions, in chunks of 24, so the
  last chunk of each pass is padded with zero rows.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dr4sr_tpu.regen import decode as jax_decode
from dr4sr_tpu.regen import generator as jax_gen
from dr4sr_tpu_torch.convert import generator_params_from_jax
from dr4sr_tpu_torch.data.synthetic import markov_sequences
from dr4sr_tpu_torch.regen import decode
from dr4sr_tpu_torch.regen.generator import Generator
from dr4sr_tpu_torch.train.checkpoint import load_jax_checkpoint, load_regenerator
from torch_one_thread import one_torch_thread  # noqa: F401  (autouse)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ARTIFACT = os.path.join(REPO, "artifacts", "regenerator_toys_a5b2K5ew1p0.msgpack")
NUM_ITEMS, K, MAX_LEN = 40, 3, 10
WIDTHS = dict(k=K, embed_dim=32, num_heads=2, num_layers=2, ffn_dim=64, dropout=0.0)


@pytest.fixture(scope="module")
def models():
    rng = np.random.default_rng(0)
    b, ls = 12, 14
    src = np.zeros((b, ls), np.int32)
    for i in range(b - 3):
        n = int(rng.integers(2, 9))
        items = rng.choice(np.arange(1, NUM_ITEMS), size=n, replace=False)
        src[i, : n + 2] = [NUM_ITEMS, *items, NUM_ITEMS + 1]
    src[b - 3, :3] = [NUM_ITEMS, 5, NUM_ITEMS + 1]  # one item
    src[b - 2, :7] = [NUM_ITEMS, 3, 9, 3, 9, 3, NUM_ITEMS + 1]  # repeats
    # src[b - 1] stays all zeros: a padded lane
    cond = rng.integers(0, K, size=b).astype(np.int32)
    gen = jax_gen.Generator(num_items=NUM_ITEMS, **WIDTHS)
    key = jax.random.PRNGKey(7)
    variables = gen.init({"params": key, "dropout": key, "gumbel": key}, jnp.asarray(src),
                         jnp.asarray(src[:, :-1]), jnp.full((b,), 5), jnp.asarray(1.0))
    module = Generator(NUM_ITEMS, **WIDTHS)
    module.load_state_dict(generator_params_from_jax(
        jax.tree_util.tree_map(np.asarray, variables["params"]), module))
    return gen, variables, module, src, cond


def jax_draws(key, steps, b):
    """The uniforms the JAX loops draw: one split of the key per step."""
    out = []
    for _ in range(steps):
        key, r = jax.random.split(key)
        out.append(np.asarray(jax.random.uniform(r, (b,))))
    return np.stack(out)


@pytest.mark.parametrize("gamma", [0.0, 0.5])
@pytest.mark.parametrize("path", ["full", "cached", "beam1", "beam3"])
def test_decode_tokens_equal_jax(models, path, gamma):
    gen, variables, module, src, cond = models
    key = jax.random.PRNGKey(3)
    args = (gen, variables, jnp.asarray(src), jnp.asarray(cond), key)
    draws = torch.from_numpy(jax_draws(key, MAX_LEN - 1, len(src)))
    s, c = torch.from_numpy(src).long(), torch.from_numpy(cond).long()
    if path == "full":
        want = jax_decode.greedy_decode_batch(*args, max_len=MAX_LEN, gamma=gamma)
        got = decode.greedy_decode_batch(module, s, c, MAX_LEN, gamma, draws=draws)
    elif path == "cached":
        want = jax_decode.greedy_decode_batch_cached(*args, max_len=MAX_LEN, gamma=gamma)
        got = decode.greedy_decode_batch_cached(module, s, c, MAX_LEN, gamma, draws=draws)
    else:
        w = int(path[-1])
        want = jax_decode.beam_decode_batch_cached(*args, max_len=MAX_LEN, gamma=gamma,
                                                   beam_width=w)
        got = decode.beam_decode_batch_cached(module, s, c, MAX_LEN, gamma, w, draws=draws)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert (got[:, 0] == NUM_ITEMS).all()
    assert got[-1, 1] == NUM_ITEMS + 1 and (got[-1, 2:] == 0).all()  # padded lane: EOS, then PAD
    if gamma == 0.0:  # restrictive: source items only, no repeats
        for row, lane in zip(got.tolist(), src):
            body = row[1 : row.index(NUM_ITEMS + 1)] if NUM_ITEMS + 1 in row else row[1:]
            assert set(body) <= set(lane.tolist()) - {0, NUM_ITEMS, NUM_ITEMS + 1}
            assert len(body) == len(set(body))


def test_beam_width_one_is_greedy_and_draws_come_from_the_generator(models):
    _, _, module, src, cond = models
    s, c = torch.from_numpy(src).long(), torch.from_numpy(cond).long()
    greedy = decode.greedy_decode_batch_cached(module, s, c, MAX_LEN, 0.5,
                                               rng=torch.Generator().manual_seed(1))
    beam = decode.beam_decode_batch_cached(module, s, c, MAX_LEN, 0.5, 1,
                                           rng=torch.Generator().manual_seed(1))
    torch.testing.assert_close(beam, greedy, rtol=0, atol=0)
    assert not module.training  # decoding puts the module in eval mode


def test_bf16_decode_obeys_the_restrictive_mask(models):
    _, _, module, src, _ = models
    seqs = [[int(x) for x in row if 0 < x < NUM_ITEMS] for row in src]
    out = decode.decode_dataset(module, seqs, K, batch_size=8, max_len=MAX_LEN,
                                precision="bf16")
    assert len(out) == K * len(seqs)
    for i, body in enumerate(out):
        assert set(body) <= set(seqs[i % len(seqs)]) and len(body) == len(set(body))
    assert module.item_embedding.weight.dtype == torch.float32  # a bf16 copy decoded


def test_decode_dataset_on_the_artifact_matches_jax():
    module = load_regenerator(ARTIFACT, device="cpu")
    params = load_jax_checkpoint(ARTIFACT)["params"]
    n = module.num_items
    seqs = markov_sequences(num_users=32, num_items=n, min_len=1, max_len=60, seed=11)
    gen = jax_gen.Generator(num_items=n, k=5)
    want = jax_decode.decode_dataset(gen, {"params": jax.tree_util.tree_map(jnp.asarray, params)},
                                     seqs, 5, batch_size=24)
    got = decode.decode_dataset(module, seqs, 5, batch_size=24)
    assert len(got) == 5 * 32
    assert got == want
    assert sum(map(len, got)) > 32  # the trained model writes sequences, not only EOS
