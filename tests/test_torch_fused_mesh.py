"""``train.steps_per_dispatch > 1`` on a mesh, on gloo ranks of the CPU
(where a group's steps run eagerly one after another: the plain version of
the CUDA graph that each rank replays on the card), held against the JAX
package's fused loop on its virtual CPU devices and against N = 1 on the
same mesh.

* SASRec under DP 2 × 1, EP 1 × 2, CP 1 × 2 and DP × EP × CP 2 × 2, and
  DR4SR+ around SASRec under DP 2 × 1 (its weighted groups, the outer
  steps between them): N = 4 equals N = 1 to the bit over a warm and a
  weighted epoch (dropout 0.1, the trainers' own draws), replicas bitwise.
* One group of 4 through ``fused_steps`` from the JAX trainer's weights
  and with its draws (negatives, Gumbel noise) against JAX's
  ``multi_train_step`` / ``multi_weighted_train_step`` on a mesh of the
  same shape: losses rtol 1e-5, weights atol 1e-5 (the tolerances of
  ``tests/test_torch_distributed.py``); the group's collectives, 4 steps'
  worth by kind and axis.
* A group whose last batch is short runs as a group and a plain step,
  the per-step path's steps to the bit.
* The CLI as torchrun starts it on a 2 × 2 mesh with ``--shard-embedding``
  at N = 4 (``--cpu``): every rank trains and reports the same metrics.
* ``fused.capture_refusal`` as a plain function: N > 1 is refused on the
  card over a gloo axis, and only there.

The ranks of one world size run in one spawn (``torch_dist_worker.fused_groups``).
"""

import copy

import jax
import numpy as np
import pytest
import torch

import torch_dist_worker as w
from dr4sr_tpu.data.dataset import prepare_datasets as jax_prepare_datasets
from dr4sr_tpu.data.synthetic import synthetic_config, write_synthetic_dataset
from dr4sr_tpu.parallel.mesh import MeshPlan as JaxMeshPlan
from dr4sr_tpu.parallel.mesh import create_mesh as jax_create_mesh
from dr4sr_tpu.train.meta_trainer import MetaTrainer as JaxMetaTrainer
from dr4sr_tpu_torch.convert import meta_params_from_jax, params_from_jax
from dr4sr_tpu_torch.models import get_model_class
from dr4sr_tpu_torch.modules.layers import MLP
from dr4sr_tpu_torch.train.fused import capture_refusal
from torch_dist_parity import NUM_ITEMS, assert_params, jax_fused_steps, jax_restoring_plans
from torch_meta_parity import CONFIG_DIR, weighted_draws
from torch_one_thread import one_torch_thread  # noqa: F401  (autouse)

L, BATCH, D, N = 10, 32, 16, 4
TABLE = "item_embedding.weight"
# name: (data, model, shard_embedding, context_parallel, DR4SR+)
RUNS = {"dp": (2, 1, False, 1, False), "ep": (1, 2, True, 1, False),
        "cp": (1, 2, False, 2, False), "2x2": (2, 2, True, 2, False),
        "meta_dp": (2, 1, False, 1, True)}
# a step's collectives by kind and axis (2 layers): the BCE count's and the
# gradients' all-reduces over data; ep_gather's 3 over model; per layer the
# ring's 10 sends and 4 all-gathers (o, dq, dk, dv)
STEP_COLLECTIVES = {
    "dp": {"all_reduce:data": 2}, "ep": {"all_reduce:model": 3},
    "cp": {"all_gather:model": 8, "send:model": 20},
    "2x2": {"all_reduce:data": 2, "all_reduce:model": 3, "all_gather:model": 8,
            "send:model": 20},
    "meta_dp": {"all_reduce:data": 2}}


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    path = str(tmp_path_factory.mktemp("fused_mesh"))
    write_synthetic_dataset(path, num_users=120, num_items=NUM_ITEMS, max_seq_len=L, seed=6)
    return path


def _config(run):
    data, model, shard, cp, meta = RUNS[run]
    cfg = synthetic_config(max_seq_len=L)
    cfg["train"].update(batch_size=BATCH, epochs=2)
    widths = {"embed_dim": D, "hidden_size": 32, "head_num": 2, "layer_num": 2,
              "dropout_rate": 0.0}
    if meta:
        cfg["model"].update(model="MetaModel", sub_model="SASRec", tau_min=1.0)
        cfg["train"].update(warmup_epoch=0, interval=3, meta_optimizer="sgd",
                            meta_learning_rate=1e-2)
        cfg["_cli_overrides"] = {"model": widths, "train": {"batch_size": BATCH}}
    else:
        cfg["model"].update(widths)
        if cp > 1:
            cfg["model"]["context_parallel"] = cp
    return cfg


def _jax_meta_fused(root, cfg, data, model, shard):
    """One group of N of the JAX ``MetaTrainer``'s ``multi_weighted_train_step``
    on its first N batches of epoch 0, keys split from PRNGKey(3)."""
    with jax_restoring_plans():
        plan = JaxMeshPlan(mesh=jax_create_mesh(data=data, model=model,
                                                devices=jax.devices()[:data * model]),
                           shard_embedding=shard)
        tr = JaxMetaTrainer(copy.deepcopy(cfg), jax_prepare_datasets(cfg, root=root),
                            mesh_plan=plan, config_dir=CONFIG_DIR)
        tr.init_state(seed=0)
        module = get_model_class("SASRec").build(tr.config, NUM_ITEMS)

        def port(params):
            return {k: v.numpy() for k, v in params_from_jax(
                jax.tree_util.tree_map(np.asarray, jax.device_get(params)), module).items()}

        mlp, tau = meta_params_from_jax(
            jax.tree_util.tree_map(np.asarray, jax.device_get(tr.meta_params)), MLP(D, (D, 2)))
        batches = list(tr.train_data.get_loader(seed=0))[:N]
        rngs = jax.random.split(jax.random.PRNGKey(3), N)
        draws = []
        for b, r in zip(batches, rngs):
            neg, _, noise = weighted_draws(tr, tr._device_batch(b, is_train=True), r)
            draws.append((neg.numpy(), noise.numpy()))
        init = port(tr.state.params)
        state, losses = tr.multi_weighted_train_step(
            tr.state, tr.meta_params, tr._device_batch_stack(batches), rngs, tr.batch_extras)
        return dict(init=init, meta_init=({k: v.numpy() for k, v in mlp.items()}, tau),
                    batches=batches, draws=draws, losses=np.asarray(losses).tolist(),
                    params=port(state.params))


@pytest.fixture(scope="module")
def refs(root):
    out = {}
    for run, (data, model, shard, cp, meta) in RUNS.items():
        cfg = _config(run)
        out[run] = (_jax_meta_fused(root, cfg, data, model, shard) if meta
                    else jax_fused_steps(root, cfg, data, model, shard, n=N))
    return out


@pytest.fixture(scope="module")
def outs(root, refs, tmp_path_factory):
    """Every run's ranks, one spawn per world size."""
    by_world = {}
    for run, (data, model, shard, cp, meta) in RUNS.items():
        by_world.setdefault(data * model, []).append(run)
    got = {}
    for world, runs in by_world.items():
        jobs = [((_config(run), root, *RUNS[run][:3], refs[run]), {"meta": RUNS[run][4]})
                for run in runs]
        ranks = w.run_ranks(w.fused_groups, world, tmp_path_factory.mktemp(f"w{world}"), jobs,
                            timeout_s=w.TIMEOUT_S * len(jobs))
        for i, run in enumerate(runs):
            got[run] = [rank[i] for rank in ranks]
    return got


def _assert_replicas(run, locals_):
    """rank = data index · model + model index: a row-sharded table is
    replicated over the data ranks of its model index, the rest over all."""
    data, model, shard = RUNS[run][:3]
    for r, local in enumerate(locals_):
        for k, v in local.items():
            twin = locals_[r % model] if (shard and k == TABLE) else locals_[0]
            np.testing.assert_array_equal(v, twin[k], err_msg=f"rank {r} {k}")


@pytest.mark.parametrize("run", list(RUNS))
def test_fused_equals_per_step_on_the_mesh(outs, run):
    for rank in outs[run]:
        n1, n4 = rank["n1"], rank["n4"]
        assert n1["losses"] == n4["losses"] and n1["step"] == n4["step"]
        for k, v in n1["local"].items():
            np.testing.assert_array_equal(n4["local"][k], v, err_msg=k)
        if RUNS[run][4]:
            for k, v in n1["meta"].items():
                np.testing.assert_array_equal(n4["meta"][k], v, err_msg=k)
    _assert_replicas(run, [rank["n4"]["local"] for rank in outs[run]])


@pytest.mark.parametrize("run", list(RUNS))
def test_fused_group_matches_jax_on_the_mesh(outs, refs, run):
    ref = refs[run]
    want = {k: N * n for k, n in STEP_COLLECTIVES[run].items()}
    for rank in outs[run]:
        group = rank["group"]
        np.testing.assert_allclose(group["losses"], ref["losses"], rtol=1e-5)
        assert_params(group["full"], ref["params"])
        assert {k: v["calls"] for k, v in group["collectives"].items()} == want
    _assert_replicas(run, [rank["group"]["local"] for rank in outs[run]])


def test_cli_trains_at_n4_on_a_2x2_mesh(root, tmp_path):
    """``torchrun --nproc-per-node 4 -m dr4sr_tpu_torch.run ... --data-parallel 2
    --model-parallel 2 --shard-embedding --set train.steps_per_dispatch=4``,
    on four gloo ranks with ``--cpu``: every rank trains its epoch in
    groups and reports the same test metrics."""
    argv = ["-m", "SASRec", "-d", "synthetic", "--root", root, "--cpu", "--epochs", "1",
            "--data-parallel", "2", "--model-parallel", "2", "--shard-embedding",
            "--set", "train.steps_per_dispatch=4", "--set", f"eval.save_path={tmp_path}",
            "--set", f"data.max_seq_len={L}", "--set", f"train.batch_size={BATCH // 2}",
            "--set", f"model.embed_dim={D}", "--set", "model.hidden_size=32"]
    ranks = w.run_ranks(w.cli, 4, tmp_path, str(tmp_path), argv)
    metrics, spd, world, steps, _ = ranks[0]
    assert (spd, world) == (4, 4) and steps >= 2 * spd  # two groups of 4 or more
    assert all(np.isfinite(v) for v in metrics.values())
    for r, (got, *rest) in enumerate(ranks[1:], 1):
        assert got == metrics and rest[:3] == [spd, world, steps], r
    _assert_replicas("2x2", [rank[4] for rank in ranks])


def test_a_short_batch_goes_as_a_run_of_its_own(root):
    """A group whose last batch has fewer rows (a loader that does not pad
    it) runs as a group of the equal-shape batches and a plain step: the
    per-step path's steps, to the bit."""
    trainers, groups = {}, []
    for spd in (4, 1):  # each seeds the dropout stream at init_state
        cfg = _config("dp")
        cfg["train"]["steps_per_dispatch"] = spd
        cfg["model"]["dropout_rate"] = 0.1
        tr = trainers[spd] = w._trainer(cfg, root, None, None)
        batches = [b for b, _ in zip(tr.train_batches(0), range(4))]
        batches[3] = {k: v[: BATCH - 5] for k, v in batches[3].items()}
        if spd > 1:
            fused = tr.fused_steps
            tr.fused_steps = lambda bs, kind, update: groups.append(len(bs)) or fused(
                bs, kind, update)
            tr.train_group(batches)
        else:
            for batch in batches:
                tr.train_step(tr.device_batch(batch, is_train=True))
    assert groups == [3] and trainers[4].step == trainers[1].step == 4
    for k, v in trainers[1].rec.module.state_dict().items():
        assert torch.equal(trainers[4].rec.module.state_dict()[k], v), k


@pytest.mark.parametrize("device,backends,refused", [
    ("cuda", ["gloo"], True), ("cuda", ["nccl", "gloo"], True), ("cuda", ["nccl"], False),
    ("cpu", ["gloo"], False), ("cuda", [], False)])
def test_capture_refused_only_on_the_card_over_gloo(device, backends, refused):
    why = capture_refusal(torch.device(device), backends)
    assert (why is not None) == refused
    if refused:
        assert "gloo" in why and "stages_through_host" in why

