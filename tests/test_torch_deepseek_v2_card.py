"""DeepSeekV2Rec on the card: the MoE layer's forward and backward make no
host synchronisation (``torch.cuda.set_sync_debug_mode("error")`` raises on
any), the bf16 model stays near the plain f32 reference, and its steps run
inside CUDA graphs (``train.steps_per_dispatch`` 2) as they run eagerly.

Marked ``card``: each skips without one. They import no JAX and read no
fixture of ``conftest.py``; on a card's machine, which has no JAX, run them
as

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_deepseek_v2_card.py -q
"""

import copy

import numpy as np
import pytest
import torch
import torch_deepseek_v2_reference as ref

from dr4sr_tpu_torch.models.base import RecModel
from dr4sr_tpu_torch.models.deepseek_v2 import DeepSeekV2Rec
from dr4sr_tpu_torch.modules.moe import DeepSeekMoE

pytestmark = pytest.mark.card

ROPE = dict(type="yarn", factor=40, original_max_position_embeddings=4096, beta_fast=32,
            beta_slow=1, mscale=0.707, mscale_all_dim=0.707)
# the published head sizes (the kernels' 192/128), small elsewhere
SMALL = dict(hidden_size=256, num_hidden_layers=3, first_k_dense_replace=1,
             intermediate_size=512, num_attention_heads=2, qk_nope_head_dim=128,
             qk_rope_head_dim=64, v_head_dim=128, kv_lora_rank=64, rms_norm_eps=1e-6,
             rope_theta=10000, rope_scaling=ROPE, n_routed_experts=16,
             n_routed_experts_held=4, expert_offset=4, num_experts_per_tok=6,
             moe_intermediate_size=128, n_shared_experts=2, norm_topk_prob=False,
             routed_scaling_factor=1.0, remat=True, loss_fn="bce")
ITEMS, L = 300, 200


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


def _batch(device, b=8, seed=0):
    gen = torch.Generator().manual_seed(seed)
    lens = torch.tensor([L, 70, 150, 5, 199, 100, 33, 180][:b])
    real = torch.arange(L)[None, :] < lens[:, None]
    seq = torch.where(real, torch.randint(1, ITEMS, (b, L), generator=gen), 0)
    item = torch.where(real, torch.randint(1, ITEMS, (b, L), generator=gen), 0)
    batch = {"in_item_id": seq, "seqlen": lens, "item_id": item,
             "valid": torch.ones(b, dtype=torch.bool)}
    return {k: v.to(device) for k, v in batch.items()}


def test_moe_layer_makes_no_host_synchronisation(card):
    layer = DeepSeekMoE(2048, 64, 6, 1408, 2, 8, 0, False, 1.0, None).to(card)
    x = torch.randn(4096, 2048, device=card, requires_grad=True)
    mask = torch.rand(4096, device=card) > 0.3
    layer(x, mask)  # kernels built and loaded before the check
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        with torch.autocast("cuda", dtype=torch.bfloat16):
            y = layer(x, mask)
        y.float().sum().backward()
    finally:
        torch.cuda.set_sync_debug_mode("default")
    torch.cuda.synchronize()
    assert torch.isfinite(x.grad).all()


def test_bf16_model_near_the_reference(card):
    cfg = {"model": SMALL, "train": {"precision": "bf16"}, "data": {"max_seq_len": L}}
    module = DeepSeekV2Rec.build(cfg, ITEMS, generator=torch.Generator().manual_seed(1)).to(card)
    params = {k: v.to(card) for k, v in ref.init_params(SMALL, ITEMS, 1).items()}
    batch = _batch(card)
    neg = torch.randint(1, ITEMS, (8, L, 1), device=card)
    loss = RecModel(cfg, module, ITEMS, 10).training_loss(batch, None, neg_id=neg)
    loss.backward()
    leaves = {k: v.clone().requires_grad_() for k, v in params.items()}
    want = ref.loss(leaves, batch, neg, SMALL)
    want.backward()
    assert abs(loss.item() - want.item()) <= 1e-3 * abs(want.item())
    norms = {k: leaves[k].grad.norm().item() for k in leaves}
    median = float(np.median(list(norms.values())))
    for k, p in module.named_parameters():
        gap = abs(p.grad.float().norm().item() - norms[k]) / max(norms[k], median)
        assert gap <= 0.05, k


def test_steps_in_cuda_graphs_as_eagerly(card, tmp_path):
    """An epoch at ``steps_per_dispatch`` 2 (graph replays, capturable Adam)
    takes the losses of the eager epoch, to Adam's rounding."""
    from dr4sr_tpu_torch.config import load_config
    from dr4sr_tpu_torch.data.dataset import prepare_datasets
    from dr4sr_tpu_torch.data.synthetic import write_synthetic_dataset
    from dr4sr_tpu_torch.train.trainer import Trainer

    root = str(tmp_path)
    write_synthetic_dataset(root, num_users=300, num_items=200, seed=0)
    losses = {}
    for spd in (1, 2):
        cfg = load_config("DeepSeekV2Rec", "synthetic")
        cfg["model"].update(copy.deepcopy(SMALL))
        cfg["train"].update(steps_per_dispatch=spd, batch_size=32)
        cfg["eval"]["save_path"] = str(tmp_path / "saved")
        t = Trainer(cfg, prepare_datasets(cfg, root=root), device="cuda")
        t.init_state()
        losses[spd] = [t.training_epoch(e) for e in range(2)]
    assert np.allclose(losses[1], losses[2], rtol=1e-3), losses
