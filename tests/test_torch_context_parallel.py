"""Context parallelism through the port's trainer (``model.context_parallel``
= the ``model`` axis size), on gloo ranks of the CPU: encoder attention
runs through the ring (``ops/ring_attention.py``), each block through the
kernels' plain forms.

* 3 Adam steps of SASRec under CP 1 × 2 and CP × DP 2 × 2 against the JAX
  trainer's CP steps (``tests/test_context_parallel.py``'s configuration
  through a ``MeshPlan`` of the same shape) and one port process, from the
  JAX trainer's weights and negatives: losses rtol 1e-5, parameters atol
  1e-5, validation metrics atol 1e-5;
* GNN under CP 1 × 2 against one port process;
* whole epochs end to end (``training_epoch`` and ``validate``) under CP
  against one port process from the same seed: the negatives' generator
  runs in lockstep on every rank;
* the refusal of a mesh whose ``model`` axis is not ``context_parallel``.
"""

import copy

import numpy as np
import pytest

import torch_dist_worker as w
from dr4sr_tpu.data.synthetic import synthetic_config, write_synthetic_dataset
from dr4sr_tpu_torch.data.dataset import prepare_datasets
from dr4sr_tpu_torch.parallel.mesh import MeshPlan
from dr4sr_tpu_torch.train.trainer import Trainer
from torch_dist_parity import NUM_ITEMS, assert_params, jax_steps, port_steps
from torch_one_thread import one_torch_thread  # noqa: F401  (autouse)


@pytest.fixture(scope="module")
def setup(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("cp"))
    write_synthetic_dataset(root, num_users=120, num_items=NUM_ITEMS, seed=5)
    cfg = synthetic_config()
    cfg["model"].update(embed_dim=16, hidden_size=32, dropout_rate=0.0)
    cfg["train"].update(batch_size=32, epochs=2)
    cfg["eval"]["topk"] = 20
    return root, cfg


def _cp(cfg, n=2):
    cfg = copy.deepcopy(cfg)
    cfg["model"]["context_parallel"] = n
    return cfg


@pytest.mark.parametrize("data", [1, 2])
def test_cp_steps_match_jax_and_one_process(tmp_path, setup, data):
    root, cfg = setup
    ref = jax_steps(root, _cp(cfg), data=data, model=2)
    single = port_steps(tmp_path, setup, ref)[0]
    outs = port_steps(tmp_path, (root, _cp(cfg)), ref, data=data, model=2)
    for losses, full, counters, metrics, rows, local in outs:
        np.testing.assert_allclose(losses, ref["losses"], rtol=1e-5)
        np.testing.assert_allclose(losses, single[0], rtol=1e-5)
        assert_params(full, ref["params"])
        assert_params(full, single[1])
        for k in ref["metrics"]:
            np.testing.assert_allclose(metrics[k], ref["metrics"][k], atol=1e-5)
        # two layers: per layer 1 + 3 all-gathers (o; dq, dk, dv) and
        # 3 + 5 + 2 sends (K, V, mask; and dK, dV), none of them a K/V all-gather
        assert counters[0]["all_gather:model"]["calls"] == 2 * 4
        assert counters[0]["send:model"]["calls"] == 2 * 10
    for other in outs[1:]:
        for k, v in outs[0][5].items():
            np.testing.assert_array_equal(other[5][k], v, err_msg=k)


def test_gnn_under_cp_matches_one_process(tmp_path, setup):
    root, cfg = setup
    cfg = copy.deepcopy(cfg)
    cfg["model"]["model"] = "GNN"
    ref = jax_steps(root, cfg)
    single = port_steps(tmp_path, (root, cfg), ref)[0]
    for losses, full, *_ in port_steps(tmp_path, (root, _cp(cfg)), ref, data=1, model=2):
        np.testing.assert_allclose(losses, ref["losses"], rtol=1e-5)
        np.testing.assert_allclose(losses, single[0], rtol=1e-5)
        assert_params(full, single[1])


def test_cp_epochs_end_to_end(tmp_path, setup):
    root, cfg = setup
    single = w.train_epochs(0, cfg, root, 1, 1, False, 2)
    for losses, metrics in w.run_ranks(w.train_epochs, 2, tmp_path, _cp(cfg), root, 1, 2,
                                       False, 2):
        np.testing.assert_allclose(losses, single[0], rtol=1e-5)
        for k, v in single[1].items():
            np.testing.assert_allclose(metrics[k], v, rtol=1e-5, atol=1e-6)


class _FakeMesh:
    def __init__(self, data, model):
        self.sizes = (data, model)

    def size(self, dim):
        return self.sizes[dim]


@pytest.mark.parametrize("mesh", [None, (4, 1), (1, 2)], ids=["no_mesh", "4x1", "1x2"])
def test_cp_requires_a_matching_model_axis(setup, mesh):
    root, cfg = setup
    cfg = _cp(cfg, 4)
    plan = None if mesh is None else MeshPlan(mesh=_FakeMesh(*mesh))
    with pytest.raises(ValueError, match="context_parallel=4"):
        Trainer(cfg, prepare_datasets(copy.deepcopy(cfg), root=root), device="cpu",
                mesh_plan=plan)
