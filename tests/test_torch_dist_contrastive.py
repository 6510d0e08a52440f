"""The contrastive models (CL4SRec, CL4SRec2, ICLRec) on a mesh, on gloo
ranks of the CPU, held against the JAX ``Trainer`` under a ``MeshPlan`` of
the same shape on its virtual CPU devices and against one port process.

* DP 2 × 1, EP 1 × 2 (the item table row-sharded), CP 1 × 2 (attention
  through the ring) and DP × EP × CP 2 × 2 (CASES): 3 Adam steps from the JAX
  trainer's initial weights on one global batch and the JAX ``_loss_fn``'s
  draws (negatives, the two views, ICLRec's augmentation draws; its intents
  from the JAX E-step), dropout 0. Losses rtol 1e-5, parameters by
  ``assert_params``; replicas bitwise equal across the ranks that hold them.
* A DP step's collectives: the two views all-gathered over ``data`` (and
  ICLRec's intent labels), each gather's backward one all-reduce, besides
  the loss count's and the gradients' all-reduces.
* ICLRec's own E-step (``refresh_state``) on every rank: bitwise one value
  across the ranks, and one process's within f32 rounding.
* The views' gather with ``gather_seq``'s backward (own chunk of the
  cotangent, no communication) gives a wrong DP gradient: the check that
  holds the ranks to one process catches it.
"""

import numpy as np
import pytest

import torch_dist_worker as w
from dr4sr_tpu.data.synthetic import synthetic_config, write_synthetic_dataset
from torch_dist_parity import BATCH, NUM_ITEMS, STEPS, assert_params, jax_steps
from torch_one_thread import one_torch_thread  # noqa: F401  (autouse)

TABLE = "item_embedding.weight"
# name: (data, model, shard_embedding, context_parallel)
MESHES = {"dp": (2, 1, False, 1), "ep": (1, 2, True, 1), "cp": (1, 2, False, 2),
          "2x2": (2, 2, True, 2)}
# CL4SRec's EP case is its 2 × 2 one
CASES = [("CL4SRec", "dp"), ("CL4SRec2", "dp"), ("ICLRec", "dp"), ("CL4SRec2", "ep"),
         ("ICLRec", "ep"), ("CL4SRec", "cp"), ("ICLRec", "cp"), ("CL4SRec", "2x2")]


def _config(model, cp=1):
    cfg = synthetic_config()
    cfg["model"].update(model=model, embed_dim=16, hidden_size=32, layer_num=1,
                        dropout_rate=0.0, augment_type="item_crop", num_intent_clusters=4)
    if cp > 1:
        cfg["model"]["context_parallel"] = cp
    cfg["train"].update(batch_size=BATCH, epochs=1)
    return cfg


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    path = str(tmp_path_factory.mktemp("dist_cl"))
    write_synthetic_dataset(path, num_users=120, num_items=NUM_ITEMS, seed=6)
    return path


@pytest.fixture(scope="module")
def runs(root, tmp_path_factory):
    """Every case's JAX reference, one port process per model, and the
    ranks of every case: the 2-rank meshes in one spawn, 2 × 2 in another
    (with the gather_seq fault's DP run in the first)."""
    refs, jobs = {}, {2: [], 4: []}
    for model, mesh in CASES:
        data, m, shard, cp = MESHES[mesh]
        cfg = _config(model, cp)
        refs[model, mesh] = ref = jax_steps(root, cfg, data=data, model=m, shard=shard,
                                            evaluate=False)
        jobs[data * m].append((None, (cfg, root, data, m, shard, ref, STEPS)))
    jobs[2].append(("gather_seq", (_config("CL4SRec"), root, 2, 1, False,
                                   refs["CL4SRec", "dp"], STEPS)))
    single = {model: w.zoo_steps(0, _config(model), root, 1, 1, False, refs[model, "dp"])
              for model in ("CL4SRec", "CL4SRec2", "ICLRec")}
    ranks = {n: w.run_ranks(w.zoo_runs, n, tmp_path_factory.mktemp(f"ranks{n}"), jobs[n],
                            timeout_s=w.TIMEOUT_S * len(jobs[n])) for n in (2, 4)}
    outs, i = {}, {2: 0, 4: 0}
    for model, mesh in CASES:
        n = MESHES[mesh][0] * MESHES[mesh][1]
        outs[model, mesh] = [r[i[n]] for r in ranks[n]]
        i[n] += 1
    fault = [r[i[2]] for r in ranks[2]]
    return refs, single, outs, fault


@pytest.mark.parametrize("model,mesh", CASES, ids=[f"{m}-{k}" for m, k in CASES])
def test_matches_jax_on_the_mesh_and_one_process(runs, model, mesh):
    refs, single, outs, _ = runs
    ref, one, ranks = refs[model, mesh], single[model], outs[model, mesh]
    data, m, shard, cp = MESHES[mesh]
    np.testing.assert_allclose(one["losses"], ref["losses"], rtol=1e-5)
    for out in ranks:
        np.testing.assert_allclose(out["losses"], ref["losses"], rtol=1e-5)
        np.testing.assert_allclose(out["losses"], one["losses"], rtol=1e-5)
        assert_params(out["full"], ref["params"])
        assert_params(out["full"], one["full"])
        if shard:  # NUM_ITEMS + 1 rows with the mask token: 62, 31 a rank
            assert out["rows"] == 31 and out["full"][TABLE].shape[0] == 62
    # rank = data index · model + model index: a table shard is replicated
    # over the data ranks of its model index, everything else everywhere
    for r, out in enumerate(ranks):
        for k, v in out["local"].items():
            twin = ranks[r % m] if (shard and k == TABLE) else ranks[0]
            np.testing.assert_array_equal(v, twin["local"][k], err_msg=f"{k} of rank {r}")


@pytest.mark.parametrize("model,gathers", [("CL4SRec", 2), ("ICLRec", 3)])
def test_a_data_parallel_step_gathers_the_views(runs, model, gathers):
    """Per step over ``data``: the views' all-gathers (ICLRec's intent
    labels besides), and all-reduces of the BCE count, of each gathered
    view's cotangents (their backward) and of the gradients."""
    _, _, outs, _ = runs
    for out in outs[model, "dp"]:
        for step in out["counters"]:
            calls = {k: v["calls"] for k, v in step.items()}
            assert calls == {"all_gather:data": gathers, "all_reduce:data": 4}, step
            # the views: [B/2, D] floats each, gathered to [B, D]
            assert step["all_gather:data"]["bytes"] >= 2 * BATCH * 16 * 4


@pytest.mark.parametrize("mesh", ["dp", "ep", "cp"])
def test_iclrec_intents_are_one_value_on_every_rank(runs, mesh):
    refs, single, outs, _ = runs
    ranks = outs["ICLRec", mesh]
    want = single["ICLRec"]["refreshed"]["intent_centroids"]
    for out in ranks:
        got = out["refreshed"]["intent_centroids"]
        np.testing.assert_array_equal(got, ranks[0]["refreshed"]["intent_centroids"])
        np.testing.assert_allclose(got, want, atol=1e-6)


def test_gather_seq_backward_loses_the_data_parallel_gradient(runs):
    """``gather_seq``'s rule keeps each rank's own chunk of its cotangent:
    rank s's cotangent of rank r's rows (r's views as negatives in s's
    InfoNCE) never reaches r. The loss is the same; the step is not."""
    refs, single, _, fault = runs
    one = single["CL4SRec"]
    for out in fault:
        np.testing.assert_allclose(out["losses"][0], one["losses"][0], rtol=1e-5)
        for want in (one["full"], refs["CL4SRec", "dp"]["params"]):
            with pytest.raises(AssertionError):
                assert_params(out["full"], want)
