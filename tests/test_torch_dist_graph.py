"""The graph models (GNN, SGL, SimGCL, NCL) on a mesh, on gloo ranks of the
CPU, held against the JAX ``Trainer`` under a ``MeshPlan`` of the same shape
on its virtual CPU devices and against one port process.

* DP 2 × 1 for all four; EP 1 × 2 (the item table row-sharded, the
  propagation over the table gathered over ``model``) for GNN, SGL and
  SimGCL; DP × EP 2 × 2 for NCL: 3 Adam steps from the JAX trainer's
  initial weights on one global batch and the JAX ``_loss_fn``'s draws
  (negatives, SGL's edge masks, SimGCL's per-layer uniforms; NCL's
  prototypes from the JAX E-step), dropout 0. Losses rtol 1e-5, parameters
  by ``assert_params``; replicas bitwise equal across the ranks that hold
  them.
* The graph terms take catalog negatives, so a DP step gathers no row: its
  only collectives are the BCE count's and the gradients' all-reduces. An
  EP step gathers the table over ``model`` once a propagating forward.
* NCL's own prototypes (``refresh_state``) on every rank: bitwise one value
  across the ranks, and one process's within f32 rounding.
"""

import numpy as np
import pytest

import torch_dist_worker as w
from dr4sr_tpu.data.synthetic import synthetic_config, write_synthetic_dataset
from torch_dist_parity import BATCH, NUM_ITEMS, STEPS, assert_params, jax_steps
from torch_one_thread import one_torch_thread  # noqa: F401  (autouse)

TABLE = "item_embedding.weight"
# name: (data, model, shard_embedding)
MESHES = {"dp": (2, 1, False), "ep": (1, 2, True), "2x2": (2, 2, True)}
CASES = [("GNN", "dp"), ("SGL", "dp"), ("SimGCL", "dp"), ("NCL", "dp"), ("GNN", "ep"),
         ("SGL", "ep"), ("SimGCL", "ep"), ("NCL", "2x2")]
MODELS = ("GNN", "SGL", "SimGCL", "NCL")


def _config(model):
    cfg = synthetic_config()
    cfg["model"].update(model=model, embed_dim=16, hidden_size=32, layer_num=1,
                        dropout_rate=0.0, graph="new", window=2, gnn_layer=2, ssl_ratio=0.2,
                        noise_eps=0.1, ssl_weight=0.3, proto_weight=0.2, ssl_temperature=0.2,
                        hyper_layers=1, num_clusters=4)
    cfg["train"].update(batch_size=BATCH, epochs=1)
    return cfg


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    path = str(tmp_path_factory.mktemp("dist_graph"))
    write_synthetic_dataset(path, num_users=120, num_items=NUM_ITEMS, seed=6)
    return path


@pytest.fixture(scope="module")
def runs(root, tmp_path_factory):
    """Every case's JAX reference, one port process per model, and the
    ranks of every case: the 2-rank meshes in one spawn, 2 × 2 in another."""
    refs, jobs = {}, {2: [], 4: []}
    for model, mesh in CASES:
        data, m, shard = MESHES[mesh]
        refs[model, mesh] = ref = jax_steps(root, _config(model), data=data, model=m,
                                            shard=shard, evaluate=False)
        jobs[data * m].append((None, (_config(model), root, data, m, shard, ref, STEPS)))
    single = {model: w.zoo_steps(0, _config(model), root, 1, 1, False, refs[model, "dp"])
              for model in MODELS}
    ranks = {n: w.run_ranks(w.zoo_runs, n, tmp_path_factory.mktemp(f"ranks{n}"), jobs[n],
                            timeout_s=w.TIMEOUT_S * len(jobs[n])) for n in (2, 4)}
    outs, i = {}, {2: 0, 4: 0}
    for model, mesh in CASES:
        n = MESHES[mesh][0] * MESHES[mesh][1]
        outs[model, mesh] = [r[i[n]] for r in ranks[n]]
        i[n] += 1
    return refs, single, outs


@pytest.mark.parametrize("model,mesh", CASES, ids=[f"{m}-{k}" for m, k in CASES])
def test_matches_jax_on_the_mesh_and_one_process(runs, model, mesh):
    refs, single, outs = runs
    ref, one, ranks = refs[model, mesh], single[model], outs[model, mesh]
    data, m, shard = MESHES[mesh]
    np.testing.assert_allclose(one["losses"], ref["losses"], rtol=1e-5)
    for out in ranks:
        np.testing.assert_allclose(out["losses"], ref["losses"], rtol=1e-5)
        np.testing.assert_allclose(out["losses"], one["losses"], rtol=1e-5)
        assert_params(out["full"], ref["params"])
        assert_params(out["full"], one["full"])
        if shard:  # 61 rows padded to 62, 31 a rank; the padding row stays 0
            assert out["rows"] == 31 and out["full"][TABLE].shape[0] == 62
            assert not out["full"][TABLE][NUM_ITEMS:].any()
    for r, out in enumerate(ranks):
        for k, v in out["local"].items():
            twin = ranks[r % m] if (shard and k == TABLE) else ranks[0]
            np.testing.assert_array_equal(v, twin["local"][k], err_msg=f"{k} of rank {r}")


@pytest.mark.parametrize("model", MODELS)
def test_a_data_parallel_step_gathers_no_row(runs, model):
    _, _, outs = runs
    for out in outs[model, "dp"]:
        for step in out["counters"]:
            assert {k: v["calls"] for k, v in step.items()} == {"all_reduce:data": 2}, step


# per EP step over ``model``: the table's all-gathers (one per propagating
# forward: GNN's encoder; SGL's and SimGCL's two views share one gather,
# NCL's layers one) and the all-reduces of ep_gather's looked-up rows
# (SASRec's input ids, and the positives and negatives of every model)
EP_STEP = {"GNN": (1, 2), "SGL": (1, 3), "SimGCL": (1, 3)}


@pytest.mark.parametrize("model", sorted(EP_STEP))
def test_an_ep_step_gathers_the_table_once(runs, model):
    _, _, outs = runs
    gathers, reduces = EP_STEP[model]
    for out in outs[model, "ep"]:
        for step in out["counters"]:
            assert step["all_gather:model"] == {"calls": gathers,
                                                "bytes": gathers * 62 * 16 * 4}, step
            assert step["all_reduce:model"]["calls"] == reduces, step
            assert set(step) == {"all_gather:model", "all_reduce:model"}, step


@pytest.mark.parametrize("mesh", ["dp", "2x2"])
def test_ncl_prototypes_are_one_value_on_every_rank(runs, mesh):
    _, single, outs = runs
    ranks = outs["NCL", mesh]
    want = single["NCL"]["refreshed"]
    for out in ranks:
        for k, v in out["refreshed"].items():
            np.testing.assert_array_equal(v, ranks[0]["refreshed"][k], err_msg=k)
        np.testing.assert_allclose(out["refreshed"]["proto_centroids"],
                                   want["proto_centroids"], atol=1e-6)
        np.testing.assert_array_equal(out["refreshed"]["proto_assign"], want["proto_assign"])
