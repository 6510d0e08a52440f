"""DR4SR+ (``MetaTrainer``) around SASRec on a mesh, on gloo ranks of the
CPU, held against the JAX ``MetaTrainer`` under a ``MeshPlan`` of the same
shape on its virtual CPU devices and against one port process.

* DP 2 × 1 and EP 1 × 2: a weighted step on the padded last batch with two
  pattern rows (``inner_loss_scale: mean``, so the global count of
  weightable positions shows), an outer step, and a weighted step under the
  updated meta parameters, from the JAX trainer's weights and its draws
  (negatives, Gumbel noise), dropout 0. JAX's own mesh tolerance
  (``tests/test_meta_fused.py``): rtol 2e-4, atol 2e-6 for the weights and
  the meta parameters; losses rtol 1e-5; the hypergradient within 1e-4 of
  each meta parameter's largest element of one process's. The replicas and
  the meta parameters bitwise equal across the ranks.
* The collectives: a DP weighted step's three all-reduces over ``data``; a
  DP outer step's 5 all-reduces of derivatives (∂L_val/∂W, 3
  Hessian-vector products, ∂(g·p)/∂φ) beside the two losses' counts; an EP
  outer step's all-reduces over ``model``, the double backward's included.
* Two faults, each caught by the comparison with one process: the
  products left out of the all-reduce (DP), and ``all_reduce_sum``'s
  backward a plain identity under ``create_graph`` (EP): its derivative
  then keeps each ``model`` rank's own table rows' share.
"""

import copy

import jax
import numpy as np
import pytest

import torch_dist_worker as w
from dr4sr_tpu.data.dataset import prepare_datasets as jax_prepare_datasets
from dr4sr_tpu.data.synthetic import synthetic_config, write_synthetic_dataset
from dr4sr_tpu.parallel.mesh import MeshPlan as JaxMeshPlan
from dr4sr_tpu.parallel.mesh import create_mesh as jax_create_mesh
from dr4sr_tpu.train.meta_trainer import MetaTrainer as JaxMetaTrainer
from dr4sr_tpu_torch.convert import meta_params_from_jax, params_from_jax
from dr4sr_tpu_torch.models import get_model_class
from dr4sr_tpu_torch.modules.layers import MLP
from torch_dist_parity import jax_restoring_plans
from torch_meta_parity import (
    CONFIG_DIR,
    assert_close_to_largest,
    jax_meta_as_port,
    outer_draws,
    weighted_draws,
)
from torch_one_thread import one_torch_thread  # noqa: F401  (autouse)

NUM_ITEMS, L, BATCH, D = 61, 10, 32, 16
RTOL, ATOL = 2e-4, 2e-6
HYPER_RTOL = 1e-4
# name: (data, model, shard_embedding)
MESHES = {"dp": (2, 1, False), "ep": (1, 2, True)}
TABLE = "item_embedding.weight"


def _config():
    cfg = synthetic_config(max_seq_len=L)
    cfg["model"].update(model="MetaModel", sub_model="SASRec", tau_min=1.0)
    cfg["train"].update(batch_size=BATCH, warmup_epoch=0, interval=3, meta_optimizer="sgd",
                        meta_learning_rate=1e-2, hpo_learning_rate=0.1,
                        meta_weight_decay=1e-3, inner_loss_scale="mean")
    cfg["_cli_overrides"] = {"model": {"embed_dim": D, "hidden_size": 32, "head_num": 2,
                                       "layer_num": 1, "dropout_rate": 0.0},
                             "train": {"batch_size": BATCH}}
    return cfg


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    path = str(tmp_path_factory.mktemp("dist_meta"))
    write_synthetic_dataset(path, num_users=120, num_items=NUM_ITEMS, max_seq_len=L, seed=6)
    return path


def _jax_run(root, data, model, shard):
    """The JAX trainer's weighted, outer and weighted steps on the mesh, the
    inputs and draws of each, and the weights after each as the port's."""
    plan = JaxMeshPlan(mesh=jax_create_mesh(data=data, model=model,
                                            devices=jax.devices()[:data * model]),
                       shard_embedding=shard)
    cfg = _config()
    tr = JaxMetaTrainer(copy.deepcopy(cfg), jax_prepare_datasets(cfg, root=root),
                        mesh_plan=plan, config_dir=CONFIG_DIR)
    tr.init_state(seed=0)
    module = get_model_class("SASRec").build(tr.config, NUM_ITEMS)
    mlp = MLP(D, (D, 2))

    def port(params):
        return {k: v.numpy() for k, v in params_from_jax(
            jax.tree_util.tree_map(np.asarray, jax.device_get(params)), module).items()}

    def meta(tree):
        return {k: v.numpy() for k, v in jax_meta_as_port(jax.device_get(tree), mlp).items()}

    tb = list(tr.train_data.get_loader(seed=1))[-1]
    assert not tb["valid"].all()
    tb["user_id"] = tb["user_id"].copy()
    tb["user_id"][:2] = 0  # pattern rows: weight 1
    loader = tr.train_data.get_loader(seed=4099)
    vb, ob = loader.sample_batch(), loader.sample_batch()
    jtb, jvb, job = (tr._device_batch(b, is_train=True) for b in (tb, vb, ob))
    mlp_state, tau = meta_params_from_jax(
        jax.tree_util.tree_map(np.asarray, jax.device_get(tr.meta_params)), mlp)
    ref = {"init": port(tr.state.params), "tb": tb, "vb": vb, "ob": ob,
           "meta_init": ({k: v.numpy() for k, v in mlp_state.items()}, tau)}
    keys = jax.random.split(jax.random.PRNGKey(13), 3)
    neg, _, noise = weighted_draws(tr, jtb, keys[0])
    ref["w1"] = (neg.numpy(), noise.numpy())
    state, loss = tr.weighted_train_step(tr.state, tr.meta_params, jtb, keys[0])
    ref["w1_loss"], ref["w1_params"] = float(loss), port(state.params)
    ref["outer"] = tuple(x.numpy() for x in outer_draws(tr, jvb, job, keys[1]))
    meta_params, _ = tr.outer_step(state.params, tr.meta_params, tr.meta_opt_state, jvb, job,
                                   keys[1])
    ref["outer_meta"] = meta(meta_params)
    neg, _, noise = weighted_draws(tr, jtb, keys[2])
    ref["w2"] = (neg.numpy(), noise.numpy())
    state, loss = tr.weighted_train_step(state, meta_params, jtb, keys[2])
    ref["w2_loss"], ref["w2_params"] = float(loss), port(state.params)
    return ref


@pytest.fixture(scope="module")
def runs(root, tmp_path_factory):
    refs = {}
    for mesh, (data, model, shard) in MESHES.items():
        with jax_restoring_plans():
            refs[mesh] = _jax_run(root, data, model, shard)
    cfg = _config()
    single = w.meta_steps(0, cfg, root, 1, 1, False, refs["dp"])
    jobs = [(cfg, root, *MESHES[mesh], refs[mesh], fault)
            for mesh, fault in (("dp", None), ("ep", None), ("dp", "hvps_unreduced"),
                                ("ep", "identity_double_backward"))]
    ranks = w.run_ranks(w.meta_runs, 2, tmp_path_factory.mktemp("meta_ranks"), jobs,
                        timeout_s=w.TIMEOUT_S * len(jobs))
    outs = {key: [r[i] for r in ranks]
            for i, key in enumerate(("dp", "ep", "dp_fault", "ep_fault"))}
    return refs, single, outs


def _assert_weights(got, want):
    for k, v in want.items():
        np.testing.assert_allclose(got[k][: v.shape[0]], v, rtol=RTOL, atol=ATOL, err_msg=k)


@pytest.mark.parametrize("mesh", sorted(MESHES))
def test_weighted_steps_match_jax_and_one_process(runs, mesh):
    refs, single, outs = runs
    ref = refs[mesh]
    _, m, shard = MESHES[mesh]
    for out in outs[mesh]:
        for step in ("w1", "w2"):
            np.testing.assert_allclose(out[f"{step}_loss"], ref[f"{step}_loss"], rtol=1e-5)
            np.testing.assert_allclose(out[f"{step}_loss"], single[f"{step}_loss"], rtol=1e-5)
            _assert_weights(out[f"{step}_params"], ref[f"{step}_params"])
            _assert_weights(out[f"{step}_params"], single[f"{step}_params"])
    ranks = outs[mesh]
    for r, out in enumerate(ranks):
        for k, v in out["local"].items():
            twin = ranks[r % m] if (shard and k == TABLE) else ranks[0]
            np.testing.assert_array_equal(v, twin["local"][k], err_msg=f"{k} of rank {r}")


@pytest.mark.parametrize("mesh", sorted(MESHES))
def test_outer_step_matches_jax_and_one_process(runs, mesh):
    refs, single, outs = runs
    for out in outs[mesh]:
        assert_close_to_largest(_tensors(out["hypergrad"]), _tensors(single["hypergrad"]),
                                HYPER_RTOL, "hypergradient")
        for k, v in refs[mesh]["outer_meta"].items():
            np.testing.assert_allclose(out["outer_meta"][k], v, rtol=RTOL, atol=ATOL, err_msg=k)
        assert any((out["outer_meta"][k] != v).any() for k, v in out["w1_meta"].items())
        for k, v in out["outer_meta"].items():  # replicated: bitwise on every rank
            np.testing.assert_array_equal(v, outs[mesh][0]["outer_meta"][k], err_msg=k)


def _tensors(tree):
    import torch

    return {k: torch.from_numpy(np.asarray(v)) for k, v in tree.items()}


def _param_bytes(params):
    return sum(v.size * 4 for k, v in params.items())


def test_data_parallel_collectives(runs):
    refs, single, outs = runs
    tree = _param_bytes(single["w1_params"])
    meta = _param_bytes(single["w1_meta"])
    for out in outs["dp"]:
        # the BCE count's and ``mean``'s count's all-reduces, then the
        # gradients' and loss's
        for step in ("w1", "w2"):
            assert {k: v["calls"] for k, v in out[f"{step}_collectives"].items()} == {
                "all_reduce:data": 3}
        # the counts of the val loss, of the train loss and of ``mean`` (4
        # bytes each), then ∂L_val/∂W, the 3 products and ∂(g·p)/∂φ: 5
        # all-reduces of derivatives
        assert out["outer_collectives"] == {
            "all_reduce:data": {"calls": 3 + 5, "bytes": 3 * 4 + 4 * tree + meta}}


def test_embedding_parallel_collectives(runs):
    """An EP outer step over ``model``: ep_gather's all-reduces in the two
    forwards (input ids, positives, negatives: 3 each), and in every
    derivative taken through them with ``create_graph`` (3 products and
    d/dφ, 3 gathers each) the sum of the ranks' cotangents."""
    _, _, outs = runs
    for out in outs["ep"]:
        assert {k: v["calls"] for k, v in out["outer_collectives"].items()} == {
            "all_reduce:model": 2 * 3 + 4 * 3}
        assert {k: v["calls"] for k, v in out["w1_collectives"].items()} == {
            "all_reduce:model": 3}


@pytest.mark.parametrize("mesh", sorted(MESHES))
def test_a_fault_in_the_outer_step_is_caught(runs, mesh):
    _, single, outs = runs
    for out in outs[f"{mesh}_fault"]:
        with pytest.raises(AssertionError):
            assert_close_to_largest(_tensors(out["hypergrad"]), _tensors(single["hypergrad"]),
                                    HYPER_RTOL, "hypergradient")
