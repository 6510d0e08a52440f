"""CL4SRec and CL4SRec2 in the port against the JAX package. ``jax.random``
and torch draw different streams, so the draws are JAX's, fed in:

* each augmentation (crop, mask, reorder, the ``item_random`` switch and
  ``random_augmentation``) given JAX's draws, reproduced from its key
  splits, equals JAX's output exactly; the port's own sampler keeps each
  transform's invariants;
* ``info_nce_loss`` in every mode (inner product or cosine, both or single
  negatives, instance labels, a ``valid`` mask, reduced or not) against
  JAX's, atol 1e-5; a row with every logit masked stays finite;
* ``cl_loss`` from JAX's views, and the trainer's whole loss (the JAX
  ``Trainer._loss_fn``: main loss + ``cl_weight`` × InfoNCE) from JAX's
  negatives and views, loss and every gradient at atol 1e-5 (dropout 0);
* CL4SRec2's augmentation batches equal those the JAX trainer merges in,
  restart of the original loader included.
"""

import copy
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch_one_thread import one_torch_thread  # noqa: F401  (autouse)
from torch_zoo_parity import (
    assert_grads_match,
    jax_aug_draws,
    port_rec,
    to_jax,
    to_torch,
    zoo_config,
)

from dr4sr_tpu.data.dataset import prepare_datasets as jax_prepare_datasets
from dr4sr_tpu.data.synthetic import write_synthetic_dataset as jax_write
from dr4sr_tpu.models.base import sample_negatives as jax_sample_negatives
from dr4sr_tpu.models.cl4srec import cl_loss as jax_cl_loss
from dr4sr_tpu.modules import augmentation as jax_aug
from dr4sr_tpu.modules.losses import info_nce_loss as jax_info_nce_loss
from dr4sr_tpu.train.trainer import Trainer as JaxTrainer
from dr4sr_tpu_torch.convert import params_from_jax
from dr4sr_tpu_torch.data.dataset import prepare_datasets
from dr4sr_tpu_torch.models.cl4srec import cl_loss
from dr4sr_tpu_torch.modules import augmentation
from dr4sr_tpu_torch.modules.losses import info_nce_loss
from dr4sr_tpu_torch.train.trainer import Trainer

NUM_ITEMS, L = 40, 10
ATOL = 1e-5
TAO, GAMMA, BETA = 0.2, 0.7, 0.2


def _seqs(seed, b=48):
    rng = np.random.default_rng(seed)
    seqlen = rng.integers(1, L + 1, size=b).astype(np.int32)
    seqlen[:3] = (1, 2, L)
    seq = np.where(np.arange(L)[None, :] < seqlen[:, None],
                   rng.integers(1, NUM_ITEMS, size=(b, L)), 0).astype(np.int32)
    return seq, seqlen


def jax_draws(kind, key, seqlen, l):
    """The port's draws for one call of JAX's ``augment(key, ..., kind)``."""
    return jax_aug_draws(kind, key, seqlen, l, tao=TAO, beta=BETA)


def _apply(seq, seqlen, draws):
    return augmentation.apply_draws(torch.from_numpy(seq).long(), torch.from_numpy(seqlen).long(),
                                    draws, tao=TAO, gamma=GAMMA, beta=BETA, mask_id=NUM_ITEMS)


@pytest.mark.parametrize("kind", ["item_crop", "item_mask", "item_reorder", "item_random"])
@pytest.mark.parametrize("seed", [0, 1, 2])
def test_augmentation_from_jax_draws_equals_jax(kind, seed):
    seq, seqlen = _seqs(seed)
    key = jax.random.PRNGKey(10 + seed)
    want_seq, want_len = jax_aug.augment(key, jnp.asarray(seq), jnp.asarray(seqlen), kind,
                                         tao=TAO, gamma=GAMMA, beta=BETA, mask_id=NUM_ITEMS)
    got_seq, got_len = _apply(seq, seqlen, jax_draws(kind, key, seqlen, L))
    np.testing.assert_array_equal(got_seq.numpy(), np.asarray(want_seq))
    np.testing.assert_array_equal(got_len.numpy(), np.asarray(want_len))


def test_random_augmentation_from_jax_draws_equals_jax():
    seq, seqlen = _seqs(3)
    key = jax.random.PRNGKey(4)
    kinds = (("item_mask",), augmentation.KINDS)
    want_seq, want_len = jax_aug.random_augmentation(
        key, jnp.asarray(seq), jnp.asarray(seqlen), 5, short_kinds=kinds[0],
        long_kinds=kinds[1], tao=TAO, gamma=GAMMA, beta=BETA, mask_id=NUM_ITEMS)
    draws = []
    for r, ks in zip(jax.random.split(key, 3)[:2], kinds):
        r_c, r_a = jax.random.split(r)
        draws.append(jax_draws(ks[int(jax.random.randint(r_c, (), 0, len(ks)))], r_a, seqlen, L))
    got_seq, got_len = augmentation.random_augmentation(
        None, torch.from_numpy(seq).long(), torch.from_numpy(seqlen).long(), 5,
        tao=TAO, gamma=GAMMA, beta=BETA, mask_id=NUM_ITEMS, draws=tuple(draws))
    np.testing.assert_array_equal(got_seq.numpy(), np.asarray(want_seq))
    np.testing.assert_array_equal(got_len.numpy(), np.asarray(want_len))


@pytest.mark.parametrize("kind", ["item_crop", "item_mask", "item_reorder"])
def test_sampled_augmentations_keep_their_invariants(kind):
    seq, seqlen = (torch.from_numpy(a).long() for a in _seqs(5))
    gen = torch.Generator().manual_seed(0)
    out, out_len = augmentation.augment(gen, seq, seqlen, kind, tao=TAO, gamma=GAMMA, beta=BETA,
                                        mask_id=NUM_ITEMS)
    real = torch.arange(L)[None, :] < seqlen[:, None]
    if kind == "item_crop":
        assert torch.equal(out_len, torch.clamp((TAO * seqlen.float()).long(), min=1))
        for s, o, n in zip(seq, out, out_len):  # a contiguous window, packed to the front
            window = o[:n].tolist()
            assert (o[n:] == 0).all()
            assert any(s[i : i + n].tolist() == window for i in range(L - int(n) + 1))
    elif kind == "item_mask":
        assert torch.equal(out_len, seqlen)
        assert torch.equal((out == NUM_ITEMS).sum(1), (GAMMA * seqlen.float()).long())
        assert torch.equal(torch.where(out == NUM_ITEMS, seq, out), seq)
        assert not (out[~real] == NUM_ITEMS).any()
    else:
        assert torch.equal(out_len, seqlen)
        assert torch.equal(out.sort(1).values, seq.sort(1).values)
    again = augmentation.augment(torch.Generator().manual_seed(0), seq, seqlen, kind, tao=TAO,
                                 gamma=GAMMA, beta=BETA, mask_id=NUM_ITEMS)[0]
    assert torch.equal(out, again)


@pytest.mark.parametrize("sim_method", ["inner_product", "cosine"])
@pytest.mark.parametrize("neg_type", ["batch_both", "batch_single"])
@pytest.mark.parametrize("labels", [False, True])
@pytest.mark.parametrize("with_valid", [False, True])
def test_info_nce_matches_jax(sim_method, neg_type, labels, with_valid):
    rng = np.random.default_rng(7)
    rep_i, rep_j = (rng.standard_normal((12, 8)).astype(np.float32) for _ in range(2))
    kw = dict(temperature=0.7, sim_method=sim_method, neg_type=neg_type)
    if labels:
        kw["instance_labels"] = rng.integers(0, 4, size=12)
    if with_valid:
        kw["valid"] = np.arange(12) % 5 != 2
    for reduce in (True, False):
        want = jax_info_nce_loss(jnp.asarray(rep_i), jnp.asarray(rep_j), reduce=reduce,
                                 **{k: jnp.asarray(v) if isinstance(v, np.ndarray) else v
                                    for k, v in kw.items()})
        got = info_nce_loss(torch.from_numpy(rep_i), torch.from_numpy(rep_j), reduce=reduce,
                            **{k: torch.from_numpy(v) if isinstance(v, np.ndarray) else v
                               for k, v in kw.items()})
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL)


def test_info_nce_stays_finite_with_every_row_masked():
    rep = torch.randn(4, 8, generator=torch.Generator().manual_seed(0))
    loss = info_nce_loss(rep, rep, valid=torch.zeros(4, dtype=torch.bool))
    assert torch.isfinite(loss) and loss.item() == 0.0
    labels = torch.zeros(4, dtype=torch.long)  # every pair shares the label
    assert torch.isfinite(info_nce_loss(rep, rep, instance_labels=labels))


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    path = str(tmp_path_factory.mktemp("cl4srec"))
    jax_write(path, num_users=60, num_items=NUM_ITEMS, max_seq_len=L, seed=2)
    # a "regenerated" train file longer than the original (CL4SRec2's main rows)
    dom = os.path.join(path, "synthetic", "syn")
    with np.load(os.path.join(dom, "train.npz")) as z:
        rows = {k: z[k] for k in z.files}
    np.savez(os.path.join(dom, "train_regen.npz"),
             **{k: np.concatenate([v, v[::-1], v[:7]]) for k, v in rows.items()})
    return path


def _config(model, **model_cfg):
    cfg = zoo_config(model, L, cl_weight=0.3, temperature=1.0, **model_cfg)
    cfg["train"]["batch_size"] = 16
    cfg["data"]["train_file"] = "_regen" if model == "CL4SRec2" else ""
    return cfg


def _jax_params(config, root):
    jax_sets = jax_prepare_datasets(config, root=root)
    trainer = JaxTrainer(config, jax_sets)
    trainer.init_state(seed=0)
    return trainer, jax.tree_util.tree_map(np.asarray, trainer.state.params)


def _last_batch(datasets):
    """The padded last batch of an epoch: some rows have valid False."""
    batch = list(datasets[0].get_loader(seed=1))[-1]
    assert not batch["valid"].all()
    return batch


@pytest.mark.parametrize("kind", ["item_crop", "item_mask", "item_reorder", "item_random"])
def test_cl_loss_from_jax_views_matches_jax(root, kind):
    config = _config("CL4SRec", augment_type=kind)
    jax_trainer, params = _jax_params(config, root)
    batch = _last_batch(jax_prepare_datasets(config, root=root))
    key = jax.random.PRNGKey(3)
    r_i, r_j, _, _ = jax.random.split(key, 4)
    aug_kw = dict(tao=TAO, gamma=GAMMA, beta=BETA, mask_id=NUM_ITEMS)
    seq, seqlen = jnp.asarray(batch["in_item_id"]), jnp.asarray(batch["seqlen"])
    views = [tuple(torch.tensor(np.asarray(a)).long()
                   for a in jax_aug.augment(r, seq, seqlen, kind, **aug_kw)) for r in (r_i, r_j)]
    if kind == "item_mask":
        assert (views[0][0] == NUM_ITEMS).any()  # the mask token reaches the encoder

    def jax_loss(p):
        return jax_cl_loss(jax_trainer.rec.module, {"params": p}, key, seq, seqlen,
                           jnp.asarray(batch["valid"]), config["model"], NUM_ITEMS)

    want, want_grads = jax.value_and_grad(jax_loss)(jax.tree_util.tree_map(jnp.asarray, params))
    module = port_rec(config, NUM_ITEMS, params).module
    tb = to_torch(batch)
    got = cl_loss(module, tb["in_item_id"].long(), tb["seqlen"].long(), tb["valid"],
                  config["model"], NUM_ITEMS, views=views)
    got.backward()
    np.testing.assert_allclose(got.item(), float(want), atol=ATOL)
    assert_grads_match(module, jax.tree_util.tree_map(np.asarray, want_grads), ATOL)


@pytest.mark.parametrize("model", ["CL4SRec", "CL4SRec2"])
def test_trainer_loss_and_gradients_match_jax(root, model):
    """The JAX ``_loss_fn`` splits ``r_cl`` off its key first, then the main
    loss splits negatives from dropout, and ``cl_loss`` splits ``r_cl`` four
    ways (two views, two dropouts): the test replays those splits."""
    config = _config(model)
    jax_trainer, params = _jax_params(config, root)
    batch = _last_batch(jax_prepare_datasets(config, root=root))
    if model == "CL4SRec2":  # views of other rows, as the trainer merges them in
        aug = next(iter(jax_trainer._original_loader(0)))
        batch.update(aug_in_item_id=aug["in_item_id"], aug_seqlen=aug["seqlen"],
                     aug_valid=aug["valid"])
    jbatch = to_jax(batch)
    key = jax.random.PRNGKey(11)
    want, want_grads = jax.value_and_grad(jax_trainer._loss_fn)(
        jax.tree_util.tree_map(jnp.asarray, params), jbatch, key)

    rest, r_cl = jax.random.split(key)
    r_neg, _ = jax.random.split(rest)
    neg = jax_sample_negatives(r_neg, jbatch, NUM_ITEMS, L)
    r_i, r_j, _, _ = jax.random.split(r_cl, 4)
    seq = jbatch.get("aug_in_item_id", jbatch["in_item_id"])
    seqlen = jbatch.get("aug_seqlen", jbatch["seqlen"])
    views = [tuple(torch.tensor(np.asarray(a)).long()
                   for a in jax_aug.augment(r, seq, seqlen, "item_random", tao=TAO, gamma=GAMMA,
                                            beta=BETA, mask_id=NUM_ITEMS))
             for r in (r_i, r_j)]

    trainer = Trainer(config, prepare_datasets(config, root=root), device="cpu")
    trainer.init_state()
    module = trainer.rec.module
    module.load_state_dict(params_from_jax(params, module))
    got = trainer.loss(trainer.device_batch(batch, is_train=True),
                       neg_id=torch.tensor(np.asarray(neg)).long(), views=views)
    got.backward()
    np.testing.assert_allclose(got.item(), float(want), atol=ATOL)
    assert_grads_match(module, jax.tree_util.tree_map(np.asarray, want_grads), ATOL)
    assert module.item_embedding.weight.shape[0] == NUM_ITEMS + 1  # the mask token's row


class _RecordingJaxTrainer(JaxTrainer):
    """Records the host batches of ``training_epoch`` and takes no step."""

    @property
    def train_step(self):
        return lambda state, batch, rng: (state, jnp.zeros(()))

    def _device_batch(self, batch, is_train=False):
        self.recorded.append(batch)
        return batch


def test_cl4srec2_augmentation_batches_equal_jax(root):
    config = _config("CL4SRec2")
    jax_trainer = _RecordingJaxTrainer(copy.deepcopy(config),
                                       jax_prepare_datasets(config, root=root))
    jax_trainer.recorded, jax_trainer.state = [], object()
    jax_trainer._rng = jax.random.PRNGKey(0)
    jax_trainer.training_epoch(2)
    trainer = Trainer(config, prepare_datasets(config, root=root), device="cpu")
    got = list(trainer.train_batches(2))
    n_original = len(trainer._original_loader(2))
    assert len(got) == len(jax_trainer.recorded) > n_original  # the loader starts over
    for g, w in zip(got, jax_trainer.recorded):
        assert sorted(g) == sorted(w)
        for key in g:
            np.testing.assert_array_equal(g[key], w[key], err_msg=key)
