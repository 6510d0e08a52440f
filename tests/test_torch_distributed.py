"""The port's multi-device layer (``dr4sr_tpu_torch/parallel/``) on gloo ranks
of the CPU, held against the JAX package on its 8 virtual CPU devices and
against one port process.

* DP at W = 2 and 4, and DP × EP 2 × 2 on the odd 61-item catalog (table
  62 rows, 31 a rank): 3 Adam steps of SASRec from the JAX trainer's
  initial weights (carried by ``convert.py``), on the same global batch and
  the JAX trainer's own negatives (its ``split(rng)[0]`` draw), dropout 0.
  Losses rtol 1e-5 and parameters atol 1e-5 against the JAX ``Trainer``
  with the same ``MeshPlan`` (the JAX tests' own tolerances) and against one
  port process; replicas bitwise equal across the ranks that hold them.
* The EP step's collectives from the counter: no all-gather, and the
  ``model`` all-reduces carry the gathered embeddings (3 · B/D · L · D
  floats), whatever the catalog's size.
* Sharded eval (``sharded_masked_topk`` under EP) against the JAX trainer's
  sharded eval and one port process; ``sharded_masked_topk`` against the
  JAX one under ``shard_map``.
* The loss's global denominators on a batch whose shards hold unequal
  numbers of valid targets.
* The differentiable collectives' backward rules.
* Sharded decode equal to one process, token for token.
* Process 0 alone writes the best checkpoint; its table is gathered and
  padded (62 rows), and it loads back into one process; the resumable
  state (table and Adam moments gathered) restores every rank's shard.
* Each refusal at world size > 1, with its reason.
"""

import copy

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as P

import torch_dist_worker as w
from dr4sr_tpu.data.synthetic import synthetic_config, write_synthetic_dataset
from dr4sr_tpu.ops.topk import sharded_masked_topk as jax_sharded_masked_topk
from dr4sr_tpu.parallel.mesh import create_mesh as jax_create_mesh
from dr4sr_tpu_torch.data.dataset import prepare_datasets
from dr4sr_tpu_torch.parallel.mesh import MeshPlan
from dr4sr_tpu_torch.quickstart import make_trainer
from dr4sr_tpu_torch.regen.decode import decode_dataset
from dr4sr_tpu_torch.regen.generator import Generator
from torch_dist_parity import BATCH, NUM_ITEMS, STEPS, assert_params, jax_steps, port_steps
from torch_one_thread import one_torch_thread  # noqa: F401  (autouse)

TABLE = "item_embedding.weight"


@pytest.fixture(scope="module")
def setup(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("dist"))
    write_synthetic_dataset(root, num_users=120, num_items=NUM_ITEMS, seed=6)
    cfg = synthetic_config()
    cfg["model"].update(embed_dim=16, hidden_size=32, dropout_rate=0.0)
    cfg["train"].update(batch_size=BATCH, epochs=1)
    cfg["eval"]["topk"] = 20
    return root, cfg


@pytest.fixture(scope="module")
def jax_single(setup):
    return jax_steps(*setup)


@pytest.fixture(scope="module")
def port_single(setup, jax_single, tmp_path_factory):
    return port_steps(tmp_path_factory.mktemp("single"), setup, jax_single)[0]


def test_one_port_process_matches_jax(jax_single, port_single):
    np.testing.assert_allclose(port_single[0], jax_single["losses"], rtol=1e-5)
    assert_params(port_single[1], jax_single["params"])


@pytest.mark.parametrize("data", [2, 4])
def test_data_parallel_matches_jax_and_one_process(tmp_path, setup, port_single, data):
    ref = jax_steps(*setup, data=data)
    outs = port_steps(tmp_path, setup, ref, data=data)
    for losses, full, counters, metrics, rows, local in outs:
        np.testing.assert_allclose(losses, ref["losses"], rtol=1e-5)
        np.testing.assert_allclose(losses, port_single[0], rtol=1e-5)
        assert_params(full, ref["params"])
        assert_params(full, port_single[1])
        # one all-reduce of the count, one of the gradients and the loss
        assert counters[0]["all_reduce:data"]["calls"] == 2
        for k in ref["metrics"]:
            np.testing.assert_allclose(metrics[k], ref["metrics"][k], atol=1e-5)
    for other in outs[1:]:  # every parameter is replicated: bitwise equal
        for k, v in outs[0][5].items():
            np.testing.assert_array_equal(other[5][k], v, err_msg=k)


def test_embedding_parallel_2x2_on_an_odd_catalog(tmp_path, setup, port_single):
    ref = jax_steps(*setup, data=2, model=2, shard=True)
    assert ref["table_rows"] == 62
    outs = port_steps(tmp_path, setup, ref, data=2, model=2, shard=True)
    b_local, length, dim = BATCH // 2, setup[1]["data"]["max_seq_len"], 16
    for losses, full, counters, metrics, rows, local in outs:
        assert rows == 31 and full[TABLE].shape[0] == 62
        assert not full[TABLE][NUM_ITEMS:].any()  # the padding row is 0 and stays 0
        np.testing.assert_allclose(losses, ref["losses"], rtol=1e-5)
        np.testing.assert_allclose(losses, port_single[0], rtol=1e-5)
        assert_params(full, ref["params"])
        assert_params(full, port_single[1])
        for step in counters:
            assert not any(k.startswith("all_gather") for k in step)
            # the gathers of in_item_id, item_id and the negatives
            assert step["all_reduce:model"] == {"calls": 3,
                                                "bytes": 3 * b_local * length * dim * 4}
        for k in ref["metrics"]:
            np.testing.assert_allclose(metrics[k], ref["metrics"][k], atol=1e-5)
            np.testing.assert_allclose(metrics[k], port_single[3][k], atol=1e-5)
    # rank = data index · 2 + model index: dense parameters equal on all four,
    # each table shard on the two data ranks that hold it
    for r, out in enumerate(outs):
        for k, v in out[5].items():
            np.testing.assert_array_equal(v, outs[r % 2][5][k], err_msg=k)
            if k != TABLE:
                np.testing.assert_array_equal(v, outs[0][5][k], err_msg=k)


@pytest.mark.parametrize("model", ["GRU4Rec", "FMLP"])
def test_the_zoo_under_dp_and_ep_2x2(tmp_path, setup, model):
    """GRU4Rec and FMLP (prefix rows, one target each) over DP × EP 2 × 2
    against the JAX trainer on the same mesh and one port process."""
    root, cfg = setup
    cfg = copy.deepcopy(cfg)
    cfg["model"]["model"] = model
    ref = jax_steps(root, cfg, data=2, model=2, shard=True)
    single = port_steps(tmp_path, (root, cfg), ref)[0]
    outs = port_steps(tmp_path, (root, cfg), ref, data=2, model=2, shard=True)
    for losses, full, counters, metrics, rows, local in outs:
        assert rows == 31
        np.testing.assert_allclose(losses, ref["losses"], rtol=1e-5)
        np.testing.assert_allclose(losses, single[0], rtol=1e-5)
        assert_params(full, ref["params"])
        assert_params(full, single[1])
        for k in ref["metrics"]:
            np.testing.assert_allclose(metrics[k], ref["metrics"][k], atol=1e-5)
        assert not any(k.startswith("all_gather") for k in counters[0])


def test_unequal_valid_rows_take_the_global_count(tmp_path, setup, jax_single):
    """Rank 0's half of the batch holds full rows, rank 1's a single valid
    row: the per-rank counts differ, and DP still takes the global mean."""
    root, cfg = setup
    batch = {k: v.copy() for k, v in jax_single["batch"].items()}
    batch["valid"][BATCH // 2 + 1:] = False
    counts = [(batch["item_id"][sl] != 0)[batch["valid"][sl]].sum()
              for sl in (slice(0, BATCH // 2), slice(BATCH // 2, BATCH))]
    assert counts[0] > 4 * counts[1] > 0
    args = (cfg, root, 2, 1, False, [batch] * STEPS, [jax_single["neg"]] * STEPS,
            jax_single["init"])
    single = w.train_steps(0, *args[:2], 1, 1, *args[4:])
    outs = w.run_ranks(w.train_steps, 2, tmp_path, *args)
    for losses, full, *_ in outs:
        np.testing.assert_allclose(losses, single[0], rtol=1e-5)
        assert_params(full, single[1])


def test_collectives_backward_rules(tmp_path):
    outs = w.run_ranks(w.collectives, 2, tmp_path)
    for rank, (s, x_grad, full, g_grad, part, r_grad) in enumerate(outs):
        np.testing.assert_array_equal(s, np.full((2, 3), 3.0))  # 1 + 2
        np.testing.assert_array_equal(x_grad, np.full((2, 3), 2.0))  # identity, not 2 x 2
        np.testing.assert_array_equal(full, [[0, 1, 2, 3, 10, 11, 12, 13]])
        np.testing.assert_array_equal(g_grad, [np.arange(4.0) + 4 * rank])  # own chunk
        np.testing.assert_array_equal(part, [np.arange(4.0) + 4 * rank])
        np.testing.assert_array_equal(r_grad, [[1, 1, 1, 1, 2, 2, 2, 2]])  # gathered


@pytest.mark.parametrize("s", [2, 4])
def test_sharded_topk_matches_jax(tmp_path, s):
    r = np.random.default_rng(s)
    n, d, b, k = 62 if s == 2 else 64, 16, 8, 20
    query = r.standard_normal((b, d)).astype(np.float32)
    table = r.standard_normal((n, d)).astype(np.float32)
    keep = np.ones(n, bool)
    keep[NUM_ITEMS:] = False  # padding rows
    keep[[5, 40]] = False
    hist = r.integers(0, NUM_ITEMS, size=(b, 6))
    mesh = jax_create_mesh(data=1, model=s, devices=jax.devices()[:s])
    fn = jax.shard_map(lambda q, t, km, h: jax_sharded_masked_topk(q, t, k, "model", km, h),
                       mesh=mesh, in_specs=(P(), P("model"), P("model"), P()), out_specs=P(),
                       check_vma=False)
    want_scores, want_ids = (np.asarray(x) for x in fn(jnp.asarray(query), jnp.asarray(table),
                                                     jnp.asarray(keep), jnp.asarray(hist)))
    for scores, ids in w.run_ranks(w.sharded_topk, s, tmp_path, s, query, table, keep, hist, k):
        np.testing.assert_allclose(scores, want_scores, atol=1e-5)
        np.testing.assert_array_equal(ids, want_ids)
        assert (ids < NUM_ITEMS).all()


@pytest.mark.parametrize("gamma,beam", [(0.0, 1), (0.5, 1), (0.5, 2)],
                         ids=["greedy", "gamma", "beam"])
def test_sharded_decode_equals_one_process(tmp_path, gamma, beam):
    num_items = 30
    kwargs = dict(num_items=num_items, k=2, embed_dim=16, num_heads=2, num_layers=1,
                  ffn_dim=32, dropout=0.0)
    gen = Generator(**kwargs, generator=torch.Generator().manual_seed(0))
    state = {k: v.numpy() for k, v in gen.state_dict().items()}
    r = np.random.default_rng(0)
    seqs = [list(r.integers(1, num_items, size=r.integers(2, 6))) for _ in range(21)]
    single = decode_dataset(gen, seqs, 2, batch_size=8, max_len=6, gamma=gamma, seed=3,
                            beam_width=beam)
    for got in w.run_ranks(w.decode, 2, tmp_path, 2, state, kwargs, seqs, 2, 8, 6, gamma, beam):
        assert got == single


def test_process_zero_writes_a_padded_checkpoint_that_loads_back(tmp_path, setup):
    root, cfg = setup
    workdir = str(tmp_path / "saved")
    outs = w.run_ranks(w.fit_and_reload, 2, tmp_path, cfg, root, 1, 2, workdir)
    assert [o[0] for o in outs] == [True, False]
    assert all(o[3] for o in outs)  # the resumable state restores each rank's shard
    params = outs[0][1]
    assert params[TABLE].shape[0] == 62
    trainer = make_trainer(copy.deepcopy(cfg), prepare_datasets(copy.deepcopy(cfg), root=root),
                           device="cpu")
    trainer.init_state()
    rec = trainer._rec_with({k: torch.from_numpy(v) for k, v in params.items()})
    assert rec.module.item_embedding.weight.shape[0] == NUM_ITEMS
    metrics = trainer._eval_epoch(trainer.val_data, "syn", rec)
    for k, v in outs[0][2].items():
        np.testing.assert_allclose(metrics[k], v, atol=1e-6)


class _FakeRows:
    """What ``quickstart.run`` logs of a dataset; no rows behind it."""

    num_users = num_items = 0

    def __len__(self):
        return 0


class _FakeMesh:
    """The two sizes a refusal reads; no process group behind it."""

    def __init__(self, data, model):
        self.sizes = (data, model)

    def size(self, dim):
        return self.sizes[dim]


@pytest.mark.parametrize("model,train,data,shard,match", [
    ("SASRec", {"steps_per_dispatch": 4}, 2, False, "CUDA graph"),
    ("CL4SRec", {}, 2, False, "all-gather of the views"),
    ("CL4SRec2", {}, 2, False, "all-gather of the views"),
    ("ICLRec", {}, 2, False, "all-gather of the views"),
    ("SGL", {}, 2, False, "all-gather of the views"),
    ("SimGCL", {}, 1, True, "all-gather of the views"),
    ("NCL", {}, 2, False, "all-gather of the views"),
    ("GNN", {}, 1, True, "whole table"),
], ids=["fused", "cl4srec", "cl4srec2", "iclrec", "sgl", "simgcl", "ncl", "gnn_ep"])
def test_refusals_at_world_size_above_one(setup, model, train, data, shard, match):
    root, cfg = setup
    cfg = copy.deepcopy(cfg)
    cfg["model"]["model"] = model
    cfg["train"].update(train)
    plan = MeshPlan(mesh=_FakeMesh(data, 2 if shard else 1), shard_embedding=shard)
    with pytest.raises(NotImplementedError, match=match):
        make_trainer(cfg, prepare_datasets(copy.deepcopy(cfg), root=root), device="cpu",
                     mesh_plan=plan)


def test_meta_trainer_refuses_a_mesh():
    cfg = {"model": {"model": "MetaModel", "sub_model": "SASRec"}}
    with pytest.raises(NotImplementedError, match="Hessian-vector"):
        make_trainer(cfg, None, device="cpu", mesh_plan=MeshPlan(mesh=_FakeMesh(2, 1)))


def test_gnn_under_data_parallelism_is_not_refused(setup, tmp_path):
    root, cfg = setup
    cfg = copy.deepcopy(cfg)
    cfg["model"]["model"] = "GNN"
    losses, metrics = w.run_ranks(w.train_epochs, 2, tmp_path, cfg, root, 2, 1, False, 1)[0]
    single = w.train_epochs(0, cfg, root, 1, 1, False, 1)
    np.testing.assert_allclose(losses, single[0], rtol=1e-5)
    for k, v in single[1].items():
        np.testing.assert_allclose(metrics[k], v, atol=1e-5)


def test_the_mesh_flags_reach_the_trainer(monkeypatch):
    """``python -m dr4sr_tpu_torch.run`` parses the four mesh flags."""
    from dr4sr_tpu_torch import run

    seen = {}

    def fake_init(backend=None, **kwargs):
        seen["backend"] = backend

    def fake_mesh(data=None, model=1, device_type=None):
        seen.update(data=data, model=model, device_type=device_type)
        return _FakeMesh(data or 1, model)

    class Stop(Exception):
        pass

    def fake_make_trainer(config, datasets, device, mesh_plan):
        seen.update(plan=mesh_plan, device=device)
        raise Stop

    import dr4sr_tpu_torch.parallel.mesh as mesh_mod
    import dr4sr_tpu_torch.quickstart as qs

    monkeypatch.setattr(mesh_mod, "init_distributed", fake_init)
    monkeypatch.setattr(mesh_mod, "create_mesh", fake_mesh)
    monkeypatch.setattr(qs, "make_trainer", fake_make_trainer)
    monkeypatch.setattr("dr4sr_tpu_torch.data.dataset.prepare_datasets",
                        lambda config, root: (_FakeRows(),) * 3)
    monkeypatch.delenv("LOCAL_RANK", raising=False)
    with pytest.raises(Stop):
        run.main(["--cpu", "-m", "SASRec", "-d", "amazon-toys", "--data-parallel", "2",
                  "--model-parallel", "2", "--shard-embedding", "--multihost"])
    assert seen["backend"] == "gloo" and seen["device"] == "cpu"
    assert (seen["data"], seen["model"], seen["device_type"]) == (2, 2, "cpu")
    assert seen["plan"].shard_embedding and seen["plan"].data_size == 2


def test_pad_and_shard_batch():
    from dr4sr_tpu_torch.parallel.mesh import pad_batch_to_multiple

    batch = {"user_id": np.arange(5), "valid": np.ones(5, bool)}
    out = pad_batch_to_multiple(batch, 4)
    np.testing.assert_array_equal(out["user_id"], [0, 1, 2, 3, 4, 0, 0, 0])
    np.testing.assert_array_equal(out["valid"], [True] * 5 + [False] * 3)
    assert pad_batch_to_multiple(batch, 5) is batch
