"""The port's regeneration pipeline against the JAX package's, on the CPU.

* Stage 1 and the assembly — ``pattern_rows``, ``train_sequences_from_rows``,
  ``build_pretraining_dataset`` (the port's miner against JAX's and against
  ``brute_force_patterns``), ``regenerated_rows``, ``assemble_train_regen``:
  equal element for element.
* Stage 2 — 3 pretrain steps (Adam β = (0.9, 0.98), eps 1e-9, optax's
  cosine decay; dropout off; the same gumbel draws fed to both) against a
  JAX loop built from ``gen.apply`` and ``optax.adam`` as in
  ``dr4sr_tpu/regen/pipeline.py:142-161``: losses atol 1e-5, parameters
  atol 1e-6; and ``pretrain_regenerator`` itself on the CPU.
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from dr4sr_tpu.data import preprocess as jax_preprocess
from dr4sr_tpu.regen import decode as jax_decode
from dr4sr_tpu.regen import generator as jax_gen
from dr4sr_tpu.regen import miner as jax_miner
from dr4sr_tpu.regen import pipeline as jax_pipeline
from dr4sr_tpu_torch.convert import generator_params_from_jax
from dr4sr_tpu_torch.data import preprocess
from dr4sr_tpu_torch.data.dataset import RowData
from dr4sr_tpu_torch.data.synthetic import markov_sequences
from dr4sr_tpu_torch.regen import miner, pipeline
from dr4sr_tpu_torch.regen.decode import regenerated_rows
from dr4sr_tpu_torch.regen.generator import Generator, frame_pairs
from torch_one_thread import one_torch_thread  # noqa: F401  (autouse)

NUM_ITEMS = 40
FIELDS = ("user_id", "in_item_id", "item_id", "seqlen", "label", "domain_id")


@pytest.fixture(scope="module")
def world():
    """Markov sequences, their seq2pat input and both packages' train rows."""
    seqs = markov_sequences(num_users=60, num_items=NUM_ITEMS, min_len=4, max_len=14, seed=3)
    user_seqs = {i + 1: s for i, s in enumerate(seqs)}
    seq2pat = preprocess.seq2pat_sequences(user_seqs)
    train = preprocess.build_splits(user_seqs, 20)[0]
    jax_train = jax_preprocess.build_splits(user_seqs, 20)[0]
    return seqs, seq2pat, train, jax_train


def assert_rows_equal(got: RowData, want):
    for field in FIELDS:
        np.testing.assert_array_equal(getattr(got, field), getattr(want, field), err_msg=field)


@pytest.mark.parametrize("span,freq", [(3, 2), (5, 2), (4, 3)])
def test_miner_matches_jax_and_brute_force(world, span, freq):
    _, seq2pat, _, _ = world
    got, got_freqs = miner.mine_patterns(seq2pat, max_span=span, min_frequency=freq, n_jobs=2)
    want, want_freqs = jax_miner.mine_patterns(seq2pat, max_span=span, min_frequency=freq,
                                               n_jobs=2)
    assert got == want and got_freqs == want_freqs
    brute = miner.brute_force_patterns(seq2pat, span, freq)
    assert brute == jax_miner.brute_force_patterns(seq2pat, span, freq)
    assert dict(zip(map(tuple, got), got_freqs)) == brute


def test_match_pairs_matches_jax_and_is_sublist(world):
    _, seq2pat, train, _ = world
    patterns, _ = miner.mine_patterns(seq2pat, 4, 2)
    seqs = pipeline.train_sequences_from_rows(train)
    got = miner.match_pairs(seqs, patterns, max_matches=4, seed=11, n_jobs=3)
    assert got == jax_miner.match_pairs(seqs, patterns, max_matches=4, seed=11, n_jobs=3)
    assert any(len(m) == 4 for m in got)
    for seq, idxs in zip(seqs, got):
        assert all(miner.is_sublist(patterns[p], seq) for p in idxs)
        assert miner.is_sublist(seq[::2], seq) and not miner.is_sublist(seq[::-1] + [0], seq)


def test_build_pretraining_dataset_matches_jax(world):
    _, seq2pat, train, jax_train = world
    assert pipeline.train_sequences_from_rows(train) == \
        jax_pipeline.train_sequences_from_rows(jax_train)
    rows, pairs = pipeline.build_pretraining_dataset(seq2pat, train, alpha=4, beta=2, n_jobs=2)
    want_rows, want_pairs = jax_pipeline.build_pretraining_dataset(seq2pat, jax_train, alpha=4,
                                                                   beta=2, n_jobs=2)
    assert rows == want_rows and pairs == want_pairs
    assert len(rows) > 0 and len(pairs) > 0
    patterns, _ = miner.mine_patterns(seq2pat, 4, 2)
    assert pipeline.pattern_rows(patterns, 20) == jax_pipeline.pattern_rows(patterns, 20)


def test_regenerated_rows_and_assembly_match_jax(world):
    _, seq2pat, train, jax_train = world
    rng = np.random.default_rng(0)
    decoded = [list(rng.integers(1, NUM_ITEMS, size=int(n))) for n in rng.integers(0, 30, 40)]
    decoded += decoded[:5] + [[7]]  # duplicates and a one-item sequence
    regen = regenerated_rows(decoded, 20)
    assert regen == jax_decode.regenerated_rows(decoded, 20)
    assert all(r[4] == [1] * 20 for r in regen)  # the JAX package's all-ones label, kept
    pat = pipeline.pattern_rows(miner.mine_patterns(seq2pat, 3, 2)[0], 20)
    got = pipeline.assemble_train_regen(train, pat, regen, 20)
    want = jax_pipeline.assemble_train_regen(jax_train, pat, regen, 20)
    assert_rows_equal(got, want)
    assert len(got) == len(train) + len(pat) + len(regen)


def test_batch_order_and_schedule():
    """The JAX loop's batch order (``default_rng(seed).permutation`` per
    epoch, the last batch wrapped) and optax's cosine decay."""
    got = list(pipeline.batch_order(10, 4, 2, seed=5))
    host = np.random.default_rng(5)
    want = []
    for _ in range(2):
        order = host.permutation(10)
        for b in range(3):
            idx = order[b * 4 : (b + 1) * 4]
            want.append(np.concatenate([idx, idx[: 4 - len(idx)]]) if len(idx) < 4 else idx)
    assert len(got) == 6 and all((g == w).all() for g, w in zip(got, want))
    sched = optax.cosine_decay_schedule(1.0, 7)
    factor = pipeline.cosine_decay(7)
    np.testing.assert_allclose([factor(s) for s in range(9)], [float(sched(s)) for s in range(9)],
                               atol=1e-7)


WIDTHS = dict(k=3, embed_dim=32, num_heads=2, num_layers=2, ffn_dim=64, dropout=0.0)


def test_optimizer_and_schedule_match_optax():
    """The port's Adam and its cosine schedule against optax's at the
    pipeline's lr (1e-3), fed the same gradients, some near Adam's eps."""
    rng = np.random.default_rng(4)
    shape, steps, lr = (64, 8), 5, 1e-3
    grads = [rng.normal(size=shape) * 10.0 ** rng.integers(-12, -1, size=shape)
             for _ in range(steps)]
    grads = [g.astype(np.float32) for g in grads]
    p0 = rng.normal(size=shape).astype(np.float32)
    tx = optax.adam(optax.cosine_decay_schedule(lr, steps), b1=0.9, b2=0.98, eps=1e-9)
    params, state = jnp.asarray(p0), None
    state = tx.init(params)
    w = torch.nn.Parameter(torch.from_numpy(p0.copy()))
    module = torch.nn.Module()
    module.w = w
    optimizer, scheduler = pipeline.regen_optimizer(module, lr, steps)
    for g in grads:
        updates, state = tx.update(jnp.asarray(g), state, params)
        params = optax.apply_updates(params, updates)
        w.grad = torch.from_numpy(g)
        optimizer.step()
        scheduler.step()
        np.testing.assert_allclose(w.detach().numpy(), np.asarray(params), rtol=0, atol=1e-6)


def test_three_pretrain_steps_match_a_jax_loop(world, monkeypatch):
    """lr 1e-5: Adam moves every element by about lr whatever its gradient,
    so where a gradient is near eps (1e-9, e.g. a GELU unit that is almost
    off), f32 rounding of 1e-10 between the packages moves the update by up
    to a tenth of lr (1.5e-5 seen at lr 1e-3). At 1e-5 that stays inside
    1e-6, while a wrong schedule (a quarter of lr by step 2) still shows;
    the optimizer at lr 1e-3 is held to optax by the test above."""
    _, seq2pat, train, _ = world
    _, pairs = pipeline.build_pretraining_dataset(seq2pat, train, alpha=4, beta=2)
    data = frame_pairs(pairs, NUM_ITEMS)
    batch, steps, lr = 16, 3, 1e-5
    order = list(pipeline.batch_order(len(data["src"]), batch, 1, seed=9))[:steps]
    noise = np.random.default_rng(1).gumbel(size=(steps, batch, 3)).astype(np.float32)

    gen = jax_gen.Generator(num_items=NUM_ITEMS, **WIDTHS)
    key = jax.random.PRNGKey(0)
    params = gen.init({"params": key, "dropout": key, "gumbel": key},
                      jnp.asarray(data["src"][:2]), jnp.asarray(data["tgt"][:2, :-1]),
                      jnp.asarray(data["tgt_len"][:2]), jnp.asarray(1.0))["params"]
    # trained-like condition weights (numpy, seeded): at init the condition
    # probabilities are uniform and the gradients behind them are
    # differences of nearly equal terms, which Adam's first steps amplify
    draw = np.random.default_rng(2)
    for dense in params["condition_encoder"]["condition_layer"].values():
        dense["kernel"] = jnp.asarray(draw.normal(0, 0.3, size=dense["kernel"].shape), jnp.float32)
    module = Generator(NUM_ITEMS, **WIDTHS)
    module.load_state_dict(generator_params_from_jax(jax.tree_util.tree_map(np.asarray, params),
                                                     module))

    tx = optax.adam(optax.cosine_decay_schedule(lr, steps), b1=0.9, b2=0.98, eps=1e-9)
    opt_state = tx.init(params)
    optimizer, scheduler = pipeline.regen_optimizer(module, lr, steps)
    fed = {}  # the draw of the step being traced: jax.random.gumbel returns it
    monkeypatch.setattr(jax.random, "gumbel", lambda k, shape, *a, **kw: fed["noise"])

    @jax.jit
    def jax_step(params, opt_state, src, tgt, tgt_len, tau, noise):
        def loss_fn(p):
            fed["noise"] = noise
            logits, cond = gen.apply({"params": p}, src, tgt[:, :-1], tgt_len, tau,
                                     training=True, rngs={"dropout": key, "gumbel": key})
            return jax_gen.generator_loss(logits, tgt[:, 1:], cond, 1.0)

        (loss, _), grads = jax.value_and_grad(loss_fn, has_aux=True)(params)
        updates, opt_state = tx.update(grads, opt_state, params)
        return optax.apply_updates(params, updates), opt_state, loss

    tau = 1.0
    for step, idx in enumerate(order):
        src, tgt, tgt_len = (data[k][idx] for k in ("src", "tgt", "tgt_len"))
        params, opt_state, want_loss = jax_step(
            params, opt_state, jnp.asarray(src), jnp.asarray(tgt), jnp.asarray(tgt_len),
            jnp.asarray(tau, jnp.float32), jnp.asarray(noise[step]))
        got = pipeline.pretrain_step(module, optimizer, scheduler,
                                     *(torch.from_numpy(a).long() for a in (src, tgt, tgt_len)),
                                     tau, 1.0, gumbel=torch.from_numpy(noise[step]))
        np.testing.assert_allclose(got["loss"].item(), float(want_loss), atol=1e-5)
        tau = max(tau * pipeline.TAU_DECAY, pipeline.TAU_FLOOR)
    want = generator_params_from_jax(jax.tree_util.tree_map(np.asarray, params), module)
    for name, p in module.state_dict().items():
        np.testing.assert_allclose(p.numpy(), want[name].numpy(), atol=1e-6, err_msg=name)


def test_pretrain_regenerator_on_the_cpu(world):
    _, seq2pat, train, _ = world
    _, pairs = pipeline.build_pretraining_dataset(seq2pat, train, alpha=4, beta=2)
    emb = np.full((NUM_ITEMS, 64), 0.5, np.float32)
    module, history = pipeline.pretrain_regenerator(pairs[:96], NUM_ITEMS, k=2, epochs=4,
                                                    batch_size=32, learning_rate=3e-3, seed=0,
                                                    pretrained_embedding=emb, device="cpu")
    assert len(history["ce"]) == 4 * 3 and np.isfinite(history["ce"]).all()
    assert np.mean(history["ce"][-3:]) < np.mean(history["ce"][:3])
    table = module.item_embedding.weight.detach()
    assert table.shape == (NUM_ITEMS + 2, 64)
    assert abs(table[:NUM_ITEMS].mean().item() - 0.5) < 0.2  # seeded from emb, then trained
    again, _ = pipeline.pretrain_regenerator(pairs[:96], NUM_ITEMS, k=2, epochs=4, batch_size=32,
                                             learning_rate=3e-3, seed=0,
                                             pretrained_embedding=emb, device="cpu")
    for a, b in zip(module.state_dict().values(), again.state_dict().values()):
        torch.testing.assert_close(a, b, rtol=0, atol=0)  # the seed decides everything


def test_entry_points_refuse_a_missing_card():
    if torch.cuda.is_available():
        pytest.skip("this machine has CUDA")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        pipeline.pretrain_regenerator([([1, 2, 3], [1, 3])], NUM_ITEMS, epochs=1)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        pipeline.hybrid_inference(Generator(NUM_ITEMS, k=2), None)
