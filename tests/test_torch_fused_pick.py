"""``augment_type: item_random`` with the pick on the device, and the
contrastive models' fused dispatch under it, on the CPU against the JAX
package.

* The pick as a draw: JAX's ``augment(key, ..., "item_random")`` for each
  ``choice`` and its ``random_augmentation``, given JAX's choice and each
  branch's draws (reproduced from its key splits), equal the port's
  ``apply_draws`` exactly.
* The sampler draws one layout whatever the pick (``pick`` [1], ``start``
  [B], ``u`` [B, L]), each branch's view is the fixed kind's view of the
  same uniforms, and under data parallelism the pick is one draw a batch,
  the same on every rank, the rows those of one process's draws.
* CL4SRec, CL4SRec2 and ICLRec under their shipped ``item_random``, and
  DR4SR+ around CL4SRec: N = 4 equals N = 1 to the bit over 2 epochs
  (dropout 0.1); the groups equal JAX's fused loop's (the recording
  subclasses of ``tests/test_torch_fused.py``).
"""

import copy
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_fused import (
    _assert_logs_equal,
    _assert_meta_equal,
    _assert_params_equal,
    _config,
    _meta_config,
    _meta_run,
    _RecordingJax,
    _RecordingPort,
    _train,
)
from torch_one_thread import one_torch_thread  # noqa: F401  (autouse)
from torch_zoo_parity import jax_aug_draws

from dr4sr_tpu.data.dataset import prepare_datasets as jax_prepare_datasets
from dr4sr_tpu.modules import augmentation as jax_aug
from dr4sr_tpu_torch.data.dataset import prepare_datasets
from dr4sr_tpu_torch.data.synthetic import write_synthetic_dataset
from dr4sr_tpu_torch.modules import augmentation
from dr4sr_tpu_torch.parallel.collectives import Axis

NUM_ITEMS, L, B = 40, 10, 48
TAO, GAMMA, BETA = 0.2, 0.7, 0.2
KW = dict(tao=TAO, gamma=GAMMA, beta=BETA, mask_id=NUM_ITEMS)


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    path = str(tmp_path_factory.mktemp("fused_pick_data"))
    write_synthetic_dataset(path, num_users=300, num_items=80, seed=3)
    return path


@pytest.fixture(scope="module")
def meta_root(tmp_path_factory):
    path = str(tmp_path_factory.mktemp("fused_pick_meta"))
    write_synthetic_dataset(path, num_users=200, num_items=60, seed=5)
    return path


def _seqs(seed, b=B):
    rng = np.random.default_rng(seed)
    seqlen = rng.integers(1, L + 1, size=b).astype(np.int32)
    seqlen[:3] = (1, 2, L)
    seq = np.where(np.arange(L)[None, :] < seqlen[:, None],
                   rng.integers(1, NUM_ITEMS, size=(b, L)), 0).astype(np.int32)
    return seq, seqlen


def _jax_pick(key, seqlen, kinds):
    """JAX's choice among ``kinds`` (``randint(r_pick, (), 0, len)``) and the
    port's draws for it: the choice as the pick, and each branch's draws
    from the branch key, as ``lax.switch`` would hand it over."""
    r_pick, r_aug = jax.random.split(key)
    choice = int(jax.random.randint(r_pick, (), 0, len(kinds)))
    branches = [jax_aug_draws(k, r_aug, seqlen, L, tao=TAO, beta=BETA) for k in kinds]
    return choice, {"kind": "item_random", "pick": torch.tensor([choice]), "branches": branches}


def _key_with_choice(choice, start):
    """The first key from PRNGKey(start) on whose split JAX picks ``choice``."""
    for i in range(start, start + 100):
        key = jax.random.PRNGKey(i)
        if int(jax.random.randint(jax.random.split(key)[0], (), 0, 3)) == choice:
            return key
    raise AssertionError(f"no key picks {choice}")


def _t(seq, seqlen):
    return torch.from_numpy(seq).long(), torch.from_numpy(seqlen).long()


@pytest.mark.parametrize("seed", [0, 1])
@pytest.mark.parametrize("choice", [0, 1, 2], ids=augmentation.KINDS)
def test_device_pick_equals_jax_switch(choice, seed):
    seq, seqlen = _seqs(seed)
    key = _key_with_choice(choice, 100 * seed)
    want_seq, want_len = jax_aug.augment(key, jnp.asarray(seq), jnp.asarray(seqlen),
                                         "item_random", **KW)
    got_choice, draws = _jax_pick(key, seqlen, augmentation.KINDS)
    assert got_choice == choice
    got_seq, got_len = augmentation.apply_draws(*_t(seq, seqlen), draws, **KW)
    np.testing.assert_array_equal(got_seq.numpy(), np.asarray(want_seq))
    np.testing.assert_array_equal(got_len.numpy(), np.asarray(want_len))


@pytest.mark.parametrize("short,long,seed", [
    (("item_mask",), augmentation.KINDS, 4),
    (("item_crop", "item_mask"), ("item_reorder",), 5),
    (augmentation.KINDS, ("item_mask", "item_reorder"), 6),
])
def test_device_picks_of_random_augmentation_equal_jax(short, long, seed):
    seq, seqlen = _seqs(seed)
    key = jax.random.PRNGKey(seed)
    want_seq, want_len = jax_aug.random_augmentation(
        key, jnp.asarray(seq), jnp.asarray(seqlen), 5, short_kinds=short, long_kinds=long, **KW)
    r_short, r_long, _ = jax.random.split(key, 3)
    draws = (_jax_pick(r_short, seqlen, short)[1], _jax_pick(r_long, seqlen, long)[1])
    got_seq, got_len = augmentation.random_augmentation(
        None, *_t(seq, seqlen), 5, short_kinds=short, long_kinds=long, draws=draws, **KW)
    np.testing.assert_array_equal(got_seq.numpy(), np.asarray(want_seq))
    np.testing.assert_array_equal(got_len.numpy(), np.asarray(want_len))


def test_the_pick_draws_one_layout_whatever_it_picks():
    """``pick`` [1], then one ``start`` uniform [B] and one ``u`` [B, L],
    in that order, for every pick; each branch's view is its fixed kind's
    view of the same uniforms; every pick occurs over 30 batches."""
    seq, seqlen = _t(*_seqs(7))
    picks = set()
    for s in range(30):
        gen, ref = torch.Generator().manual_seed(s), torch.Generator().manual_seed(s)
        draws = augmentation.sample_draws(gen, seq, seqlen, "item_random", tao=TAO, beta=BETA)
        pick = torch.randint(0, 3, (1,), generator=ref)
        start, u = torch.rand(B, generator=ref), torch.rand(B, L, generator=ref)
        assert torch.equal(gen.get_state(), ref.get_state())
        assert torch.equal(draws["pick"], pick)
        views = []
        for kind, branch in zip(augmentation.KINDS, draws["branches"]):
            fixed = augmentation._kind_draws(kind, seqlen, start, u, TAO, BETA)
            assert branch["kind"] == kind
            for k in ("start", "u"):
                assert (branch[k] is None) == (fixed[k] is None)
                assert branch[k] is None or torch.equal(branch[k], fixed[k])
            views.append(augmentation.apply_draws(seq, seqlen, fixed, **KW))
        got = augmentation.apply_draws(seq, seqlen, draws, **KW)
        want = views[int(pick)]
        assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
        picks.add(int(pick))
    assert picks == {0, 1, 2}


def test_pick_is_one_draw_a_batch_on_every_data_rank():
    """Two data ranks draw in lockstep: the same pick as one process, and
    each rank's branch draws are its rows of one process's."""
    seq, seqlen = _t(*_seqs(8))
    whole = augmentation.sample_draws(torch.Generator().manual_seed(3), seq, seqlen,
                                      "item_random", tao=TAO, beta=BETA)
    for index in range(2):
        axis = Axis("data", None, 2, index, (0, 1))
        rows = slice(index * B // 2, (index + 1) * B // 2)
        mine = augmentation.sample_draws(torch.Generator().manual_seed(3), seq[rows],
                                         seqlen[rows], "item_random", tao=TAO, beta=BETA,
                                         axis=axis)
        assert torch.equal(mine["pick"], whole["pick"])
        for got, want in zip(mine["branches"], whole["branches"]):
            for k in ("start", "u"):
                assert got[k] is None or torch.equal(got[k], want[k][rows])
        got = augmentation.apply_draws(seq[rows], seqlen[rows], mine, **KW)[0]
        assert torch.equal(got, augmentation.apply_draws(seq, seqlen, whole, **KW)[0][rows])


@pytest.mark.parametrize("model", ["CL4SRec", "CL4SRec2", "ICLRec"])
def test_fused_equals_per_step_under_item_random(root, model):
    """The shipped ``augment_type``: N = 4 ≡ N = 1 over 2 epochs."""
    runs = []
    for spd in (1, 4):
        cfg = _config(model, small=True, steps_per_dispatch=spd)
        assert cfg["model"].get("augment_type", "item_random") == "item_random"
        runs.append(_train(cfg, root, 2))
    (single, l1), (fused, l2) = runs
    assert single.step == fused.step
    _assert_params_equal(single.rec.module, fused.rec.module)
    assert l1 == l2


@pytest.mark.parametrize("model", ["CL4SRec", "CL4SRec2", "ICLRec"])
def test_groups_under_item_random_match_jax(root, model):
    """The dispatches of two epochs at N = 4 (group sizes, leftover steps,
    every row), as JAX's fused loop makes them under the same config."""
    cfg = _config(model, small=True, steps_per_dispatch=4)
    cfg["model"]["augment_type"] = "item_random"
    jax_tr = _RecordingJax(copy.deepcopy(cfg), jax_prepare_datasets(cfg, root=root))
    jax_tr.log, jax_tr._rng = [], jax.random.PRNGKey(0)
    jax_tr.state = types.SimpleNamespace(params=None)
    # the recorded loop runs no step: ICLRec's intents are not fitted
    jax_tr.model_class = type(model, (jax_tr.model_class,), {"refresh_state": None})
    port = _RecordingPort(copy.deepcopy(cfg), prepare_datasets(cfg, root=root), device="cpu")
    port.init_state()
    port.log, port.refresh_state = [], lambda nepoch: None
    for nepoch in range(2):
        jax_tr.training_epoch(nepoch)
        port.training_epoch(nepoch)
    assert any(e[0] == "group" for e in port.log)
    _assert_logs_equal(port.log, jax_tr.log)


def test_meta_around_item_random_cl4srec_fused_equals_per_step(meta_root):
    """DR4SR+ around CL4SRec with ``item_random`` views: N = 4 ≡ per-step
    through a warm epoch and a weighted one (``interval`` 3)."""
    cfg = _meta_config()
    cfg["model"]["sub_model"] = "CL4SRec"
    cfg["_cli_overrides"]["model"].update(embed_dim=16, hidden_size=32,
                                          augment_type="item_random")
    single, l1, c1 = _meta_run(cfg, meta_root, 2, 1)
    fused, l2, c2 = _meta_run(cfg, meta_root, 2, 4)
    assert single.config["model"]["augment_type"] == "item_random"
    _assert_meta_equal(single, fused)
    assert l1 == l2 and c1 == c2 and c1
