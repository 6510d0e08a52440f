"""``model.remat`` as a CUDA graph can hold it, on the CPU: each encoder
layer recomputed in the backward with the dropout masks of its first
forward (``modules/layers.py::_KeptDropout``), no generator state saved or
restored on the host.

* Gradients with and without remat are equal to the bit at dropout > 0
  from the same draws, and the generators end in the same state; a
  trainer's Adam step with remat equals one without.
* ``train.steps_per_dispatch = 4`` with remat equals N = 1 to the bit over
  2 epochs.
* Parity with the JAX package's ``nn.remat`` SASRec (dropout 0): the loss
  and every gradient from the same weights and negatives, atol 1e-5.
* The remat'd forward and backward never call a ``get_rng_state`` or
  ``set_rng_state``.
"""

import copy

import numpy as np
import pytest
import torch
from test_torch_fused import _assert_params_equal, _config, _train
from torch_one_thread import one_torch_thread  # noqa: F401  (autouse)
from torch_zoo_parity import (
    assert_grads_match,
    jax_loss_and_grads,
    jax_rec_and_params,
    port_rec,
    to_torch,
    zoo_config,
)

from dr4sr_tpu_torch.data.dataset import prepare_datasets
from dr4sr_tpu_torch.data.synthetic import write_synthetic_dataset
from dr4sr_tpu_torch.modules.layers import TransformerEncoder
from dr4sr_tpu_torch.train.trainer import Trainer

NUM_ITEMS, L, B = 40, 10, 6
ATOL = 1e-5


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    path = str(tmp_path_factory.mktemp("remat_data"))
    write_synthetic_dataset(path, num_users=300, num_items=80, seed=3)
    return path


def _encode_and_grads(enc, x0, pad, remat):
    enc.remat = remat
    enc.zero_grad()
    x = x0.clone().requires_grad_()
    torch.manual_seed(5)
    y = enc(x, pad)
    (y * torch.linspace(-1, 1, y.shape[-1])).sum().backward()
    return y.detach(), x.grad, {k: p.grad.clone() for k, p in enc.named_parameters()}, \
        torch.get_rng_state()


@pytest.mark.parametrize("dropout", [0.1, 0.5])
def test_remat_gradients_equal_without_at_dropout(dropout):
    enc = TransformerEncoder(2, 16, 2, 32, dropout=dropout,
                             generator=torch.Generator().manual_seed(0)).train()
    x0 = torch.randn(5, L, 16, generator=torch.Generator().manual_seed(1))
    pad = torch.arange(L)[None, :] >= torch.tensor([L, 3, 1, 7, 5])[:, None]
    plain = _encode_and_grads(enc, x0, pad, False)
    remat = _encode_and_grads(enc, x0, pad, True)
    assert torch.equal(plain[0], remat[0]) and torch.equal(plain[1], remat[1])
    assert plain[2].keys() == remat[2].keys()
    for k, g in plain[2].items():
        assert torch.equal(g, remat[2][k]), k
    assert torch.equal(plain[3], remat[3])  # the recompute drew nothing


def test_trainer_step_with_remat_equals_without(root):
    """SASRec's Adam steps at dropout 0.5, from the same state and draws."""
    trainers = []
    for remat in (False, True):
        cfg = _config(small=True)
        cfg["model"].update(remat=remat, dropout_rate=0.5)
        tr = Trainer(cfg, prepare_datasets(cfg, root=root), device="cpu")
        tr.init_state()
        for batch, _ in zip(tr.train_batches(0), range(3)):
            tr.train_step(tr.device_batch(batch, is_train=True))
        trainers.append(tr)
    assert trainers[1].rec.module.encoder.remat
    _assert_params_equal(trainers[0].rec.module, trainers[1].rec.module)
    assert torch.equal(trainers[0].generator.get_state(), trainers[1].generator.get_state())


def test_remat_fused_equals_per_step(root):
    """N = 4 ≡ N = 1 with remat over 2 epochs."""
    runs = []
    for spd in (1, 4):
        cfg = _config(small=True, steps_per_dispatch=spd)
        cfg["model"]["remat"] = True
        runs.append(_train(cfg, root, 2))
    (single, l1), (fused, l2) = runs
    _assert_params_equal(single.rec.module, fused.rec.module)
    assert l1 == l2 and single.step == fused.step


def _batch(seed):
    rng = np.random.default_rng(seed)
    seqlen = np.array([L, 5, 1, 7, 2, 1])
    seq = rng.integers(1, NUM_ITEMS, size=(B, L))
    target = rng.integers(1, NUM_ITEMS, size=(B, L))
    pad = np.arange(L)[None, :] >= seqlen[:, None]
    seq[pad] = 0
    target[pad] = 0
    batch = {"in_item_id": seq, "item_id": target, "seqlen": seqlen, "valid": np.arange(B) < 5}
    return batch, rng.integers(1, NUM_ITEMS, size=(B, L, 1))


def test_remat_matches_jax_nn_remat():
    """The JAX package's SASRec under ``nn.remat`` and the port's with
    remat: loss and gradients from the same weights and negatives."""
    config = zoo_config("SASRec", L, remat=True)
    batch, neg = _batch(2)
    rec, params = jax_rec_and_params(config, NUM_ITEMS, batch)
    want_loss, want_grads = jax_loss_and_grads(rec, params, batch, neg)
    port = port_rec(copy.deepcopy(config), NUM_ITEMS, params)
    assert port.module.encoder.remat
    port.module.train()
    loss = port.training_loss(to_torch(batch), None, neg_id=torch.from_numpy(neg))
    loss.backward()
    np.testing.assert_allclose(loss.item(), want_loss, atol=ATOL)
    assert_grads_match(port.module, want_grads, ATOL)


def test_remat_touches_no_generator_state(monkeypatch):
    """The remat'd forward and backward read and set no RNG state on the
    host (a CUDA graph could not hold it)."""
    enc = TransformerEncoder(2, 16, 2, 32, dropout=0.3, remat=True,
                             generator=torch.Generator().manual_seed(0)).train()
    x = torch.randn(4, L, 16, requires_grad=True)

    def refused(*args, **kwargs):
        raise AssertionError("a generator state read or set on the host")

    for name in ("get_rng_state", "set_rng_state"):
        monkeypatch.setattr(torch, name, refused)
        monkeypatch.setattr(torch.random, name, refused)
        monkeypatch.setattr(torch.cuda, name, refused)
    enc(x).sum().backward()
    assert x.grad is not None and all(p.grad is not None for p in enc.parameters())
