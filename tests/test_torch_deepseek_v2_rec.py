"""DeepSeekV2Rec (``models/deepseek_v2.py``: MLA, DeepSeekMoE) on the CPU at a
tiny size, against the plain f32 reference (``torch_deepseek_v2_reference.py``)
on the same seeded weights: the forward, the loss and every gradient leaf;
the expert shares of a MoE layer adding up to the whole layer; the folded
layer (``fold_foreign_experts``) as a whole layer of repeated experts; YaRN's
frequencies and scale by hand; pad positions leaving the real ones alone;
no token dropped at the largest load; the load counters; the CLI's two
steps and ``Recommender``'s top-k."""

import glob
import math
import os

import numpy as np
import pytest
import torch
import torch_deepseek_v2_reference as ref

from dr4sr_tpu_torch.models.base import RecModel
from dr4sr_tpu_torch.models.deepseek_v2 import DeepSeekV2Rec
from dr4sr_tpu_torch.modules.mla import yarn_inv_freq, yarn_mscale
from dr4sr_tpu_torch.modules.moe import DeepSeekMoE
from dr4sr_tpu_torch.utils import spans

ROPE = dict(type="yarn", factor=40, original_max_position_embeddings=4096, beta_fast=32,
            beta_slow=1, mscale=0.707, mscale_all_dim=0.707)
TINY = dict(hidden_size=64, num_hidden_layers=3, first_k_dense_replace=1, intermediate_size=96,
            num_attention_heads=2, qk_nope_head_dim=16, qk_rope_head_dim=8, v_head_dim=16,
            kv_lora_rank=32, rms_norm_eps=1e-6, rope_theta=10000, rope_scaling=ROPE,
            n_routed_experts=16, n_routed_experts_held=4, expert_offset=4,
            num_experts_per_tok=6, moe_intermediate_size=32, n_shared_experts=2,
            norm_topk_prob=False, routed_scaling_factor=1.0, loss_fn="bce")
ITEMS, L = 50, 12


def _config(**model):
    return {"model": dict(TINY, **model), "train": {"precision": "fp32"},
            "data": {"max_seq_len": L}}


def _batch(seed=0, b=4):
    gen = torch.Generator().manual_seed(seed)
    seq = torch.randint(1, ITEMS, (b, L), generator=gen)
    seqlen = torch.tensor([L, 7, 3, 10][:b])
    real = torch.arange(L)[None, :] < seqlen[:, None]
    seq = torch.where(real, seq, 0)
    item = torch.where(real, torch.randint(1, ITEMS, (b, L), generator=gen), 0)
    return {"in_item_id": seq, "seqlen": seqlen, "item_id": item,
            "valid": torch.tensor([True, True, True, False][:b])}


@pytest.mark.parametrize("remat,fold", [(False, False), (True, False), (False, True)])
def test_module_matches_the_reference(remat, fold):
    cfg = _config(remat=remat, fold_foreign_experts=fold)
    module = DeepSeekV2Rec.build(cfg, ITEMS, generator=torch.Generator().manual_seed(3))
    params = ref.init_params(cfg["model"], ITEMS, 3)
    named = dict(module.named_parameters())
    assert set(named) == set(params) and all(torch.equal(named[k], params[k]) for k in params)
    batch = _batch()
    neg = torch.randint(1, ITEMS, (4, L, 1), generator=torch.Generator().manual_seed(9))
    rec = RecModel(cfg, module, ITEMS, 10)
    loss = rec.training_loss(batch, None, neg_id=neg)
    loss.backward()
    leaves = {k: v.clone().requires_grad_() for k, v in params.items()}
    want = ref.loss(leaves, batch, neg, cfg["model"])
    want.backward()
    assert abs(loss.item() - want.item()) <= 1e-6 * abs(want.item())
    for k, p in named.items():
        w = leaves[k].grad
        assert (p.grad - w).abs().max() <= 1e-5 * max(w.abs().max().item(), 1e-8), k
    # eval: the last real position's state scores the catalog as the reference's
    scores, _ = rec.topk(batch, 5)
    want_scores = ref.serve_scores(params, batch["in_item_id"], batch["seqlen"], cfg["model"])
    got = scores.detach()
    assert (got - want_scores.topk(5).values).abs().max() <= 1e-5 * want_scores.abs().max()


def test_expert_shares_add_up_to_the_whole_layer():
    """Eight shares of a 16-expert layer, 2 experts each, with the shared
    experts counted once, sum to the layer that holds all 16."""
    d, gen_seed = 24, 5
    whole = DeepSeekMoE(d, 16, 6, 8, 2, 16, 0, False, 1.0, torch.Generator().manual_seed(gen_seed))
    x = torch.randn(3, 7, d, generator=torch.Generator().manual_seed(1))
    mask = torch.ones(3, 7, dtype=torch.bool)
    mask[1, 4:] = False
    shared = whole.shared(x)
    total = torch.zeros_like(x)
    for share in range(8):
        part = DeepSeekMoE(d, 16, 6, 8, 2, 2, 2 * share, False, 1.0, None)
        with torch.no_grad():
            part.gate.copy_(whole.gate)
            for name in ("w_gate", "w_up", "w_down"):
                getattr(part, name).copy_(getattr(whole, name)[2 * share:2 * share + 2])
            part.shared.load_state_dict(whole.shared.state_dict())
        total += part(x, mask) - shared
    with torch.no_grad():
        assert (total + shared - whole(x, mask)).abs().max() <= 1e-5
        # a pad token takes no routed expert: only the shared ones
        assert (whole(x, mask)[1, 4:] - shared[1, 4:]).abs().max() == 0


def test_folded_layer_is_a_whole_layer_of_repeated_experts():
    """With ``fold_foreign``, a layer holding experts 4-7 of 16 computes each
    assignment to expert e on held expert 4 + (e - 4) mod 4: the whole layer
    whose expert e has those weights. Every real token's 6 assignments land
    on the held experts."""
    d = 24
    part = DeepSeekMoE(d, 16, 6, 8, 2, 4, 4, False, 1.0, torch.Generator().manual_seed(6),
                       fold_foreign=True)
    whole = DeepSeekMoE(d, 16, 6, 8, 2, 16, 0, False, 1.0, None)
    held = [4 + (e - 4) % 4 - 4 for e in range(16)]
    with torch.no_grad():
        whole.gate.copy_(part.gate)
        for name in ("w_gate", "w_up", "w_down"):
            getattr(whole, name).copy_(getattr(part, name)[held])
        whole.shared.load_state_dict(part.shared.state_dict())
    x = torch.randn(3, 7, d, generator=torch.Generator().manual_seed(1))
    mask = torch.ones(3, 7, dtype=torch.bool)
    mask[2, 3:] = False
    with torch.no_grad():
        want = whole(x, mask)
        with torch.profiler.profile():
            spans.reset_counts()
            got = part(x, mask)
            counts = spans.read_counts()
    spans.reset_counts()
    assert (got - want).abs().max() <= 1e-5
    assert int(counts["moe.assignments"].sum()) == 6 * int(mask.sum())


def test_no_token_is_dropped_at_the_largest_load():
    """Every token's top-6 on the held experts (a router that prefers
    experts 0-5 for every token, all held): the buffer's N·k rows are all
    used, and the layer is the reference's dense sum over the assignments."""
    d = 16
    layer = DeepSeekMoE(d, 8, 6, 8, 1, 8, 0, False, 1.0, torch.Generator().manual_seed(2))
    with torch.no_grad():
        layer.gate.zero_()
        layer.gate[:6, 0] = torch.arange(6, 0, -1, dtype=torch.float32)  # x[..., 0] > 0 below
    x = torch.randn(5, d, generator=torch.Generator().manual_seed(4))
    x[:, 0] = x[:, 0].abs() + 1
    p = {f"mlp.{k}": v.detach() for k, v in layer.state_dict().items()}
    m = dict(n_routed_experts=8, num_experts_per_tok=6, n_routed_experts_held=8,
             expert_offset=0, norm_topk_prob=False, routed_scaling_factor=1.0)
    with torch.no_grad(), ref.full_f32():
        want = ref.moe(p, "mlp.", x, torch.ones(5, dtype=torch.bool), m, ref.PLAIN)
        with torch.profiler.profile():
            spans.reset_counts()
            got = layer(x)
            counts = spans.read_counts()
    assert (got - want).abs().max() <= 1e-5
    assert counts["moe.assignments"].tolist() == [5] * 6 + [0, 0]
    assert int(counts["moe.tokens"]) == 5
    spans.reset_counts()


def test_load_counters_count_each_forward_once_under_remat():
    """Under a profiler the counters add each MoE layer's held assignments
    and real tokens once a forward; remat's recomputation inside the
    backward is not counted again. Without a profiler nothing is counted."""
    cfg = _config(remat=True)
    module = DeepSeekV2Rec.build(cfg, ITEMS, generator=torch.Generator().manual_seed(3))
    batch = _batch()
    spans.reset_counts()
    module.train()
    module(batch).sum().backward()
    assert spans.read_counts() == {}
    with torch.profiler.profile():
        module(batch).sum().backward()
        counts = spans.read_counts()
    spans.reset_counts()
    real = int(batch["seqlen"].sum())
    moe_layers = TINY["num_hidden_layers"] - TINY["first_k_dense_replace"]
    assert int(counts["moe.tokens"]) == moe_layers * real
    assert counts["moe.assignments"].shape == (TINY["n_routed_experts_held"],)
    assert 0 < counts["moe.assignments"].sum() <= moe_layers * real * 6


def test_yarn_frequencies_and_scale_by_hand():
    """DeepSeek-V2-Lite's rope: d 64, θ 1e4, factor 40, original length 4096,
    β 32 / 1. The correction range is [floor(10.47), ceil(22.51)] = [10, 23]:
    below it the frequencies are θ^(-2i/64), above it those over 40, and a
    linear ramp between. The softmax scale is 192^-½·(0.1·0.707·ln 40 + 1)²."""
    inv = yarn_inv_freq(64, 10000.0, 40.0, 4096, 32.0, 1.0).double()
    low = 64 * math.log(4096 / (32 * 2 * math.pi)) / (2 * math.log(10000))
    high = 64 * math.log(4096 / (1 * 2 * math.pi)) / (2 * math.log(10000))
    assert (math.floor(low), math.ceil(high)) == (10, 23)
    for i in (0, 5, 10):
        assert inv[i].item() == pytest.approx(10000 ** (-2 * i / 64), rel=1e-6)
    for i in (23, 28, 31):
        assert inv[i].item() == pytest.approx(10000 ** (-2 * i / 64) / 40, rel=1e-6)
    ramp = (16 - 10) / (23 - 10)  # i = 16: 6/13 of the way to the interpolated
    want = 10000 ** (-32 / 64) * (1 - ramp) + 10000 ** (-32 / 64) / 40 * ramp
    assert inv[16].item() == pytest.approx(want, rel=1e-6)
    assert torch.equal(inv.float(), ref.yarn_inv_freq(64, 10000.0, 40.0, 4096, 32.0, 1.0))
    mscale = 0.1 * 0.707 * math.log(40) + 1
    assert yarn_mscale(40, 0.707) == pytest.approx(1.260804, abs=1e-6)
    module = DeepSeekV2Rec.build(_config(qk_nope_head_dim=128, qk_rope_head_dim=64,
                                         v_head_dim=128), ITEMS)
    attn = module.layers[0].attn
    assert attn.softmax_scale == pytest.approx(192 ** -0.5 * mscale ** 2, rel=1e-12)
    assert attn.softmax_scale == pytest.approx(192 ** -0.5 * 1.589627, rel=1e-6)
    assert attn.rope_mscale == 1.0


def test_pad_positions_leave_the_real_ones_alone():
    """A history's real positions come out the same whatever follows them
    in its row (other items, which the mask makes pads, or none) and
    whatever the other rows of the batch hold."""
    cfg = _config()
    module = DeepSeekV2Rec.build(cfg, ITEMS, generator=torch.Generator().manual_seed(3))
    module.train()
    batch = _batch()
    out = module(batch)
    other = dict(batch)
    other["in_item_id"] = batch["in_item_id"].clone()
    other["in_item_id"][1:, :] = torch.randint(1, ITEMS, (3, L))
    other["in_item_id"][0, :] = batch["in_item_id"][0]
    other["in_item_id"][1, 7:] = 0  # row 1 keeps its length, its others change
    shorter = {k: v[:, :9] if v.dim() == 2 else v for k, v in batch.items()}
    shorter["seqlen"] = batch["seqlen"].clamp(max=9)
    with torch.no_grad():
        alone = module({k: v[:1] for k, v in batch.items()})
        assert (out[0] - alone[0]).abs().max() <= 1e-5
        cut = module(shorter)
        for row in (1, 2):
            n = int(batch["seqlen"][row])
            assert (out[row, :n] - cut[row, :n]).abs().max() <= 1e-5
        assert (module(other)[0] - out[0]).abs().max() <= 1e-5


def test_cli_takes_two_steps_and_the_recommender_serves(tmp_path):
    from dr4sr_tpu_torch import run
    from dr4sr_tpu_torch.data.synthetic import write_synthetic_dataset
    from dr4sr_tpu_torch.serve import Recommender

    root = str(tmp_path / "data")
    write_synthetic_dataset(root, num_users=40, num_items=30, seed=1)
    sets = [f"model.{k}={v}" for k, v in TINY.items() if k not in ("rope_scaling", "loss_fn")]
    args = ["-m", "DeepSeekV2Rec", "-d", "synthetic", "--root", root, "--cpu", "--epochs", "1",
            "--set", "train.batch_size=20", "--set", "train.precision=fp32",
            "--set", f"eval.save_path={tmp_path / 'saved'}"]
    for s in sets:
        args += ["--set", s]
    out = run.main(args)
    assert out and all(np.isfinite(v) for v in out.values())
    (path,) = glob.glob(os.path.join(str(tmp_path / "saved"), "DeepSeekV2Rec", "synthetic",
                                     "*.ckpt"))
    server = Recommender.from_checkpoint(path, root=root, device="cpu", batch_size=4)
    items, scores = server.recommend([[3, 4, 5], [7], [1, 2, 3, 4, 5, 6]], k=5)
    assert items.shape == scores.shape == (3, 5)
    assert (items > 0).all() and not np.isin(items[0], [3, 4, 5]).any()
    assert (np.diff(scores, axis=1) <= 0).all()


def test_steps_run_through_the_trainer(tmp_path):
    """Two steps through ``Trainer.train_step`` at the configuration's bf16
    (CPU autocast) and at f32 take finite losses that drop."""
    from dr4sr_tpu_torch.config import load_config
    from dr4sr_tpu_torch.data.dataset import prepare_datasets
    from dr4sr_tpu_torch.data.synthetic import write_synthetic_dataset
    from dr4sr_tpu_torch.train.trainer import Trainer

    root = str(tmp_path)
    write_synthetic_dataset(root, num_users=40, num_items=30, seed=2)
    cfg = load_config("DeepSeekV2Rec", "synthetic")
    assert cfg["train"]["precision"] == "bf16" and cfg["model"]["remat"] is True
    cfg["model"].update({k: v for k, v in TINY.items() if k != "rope_scaling"})
    cfg["train"]["batch_size"] = 16
    cfg["eval"]["save_path"] = str(tmp_path / "saved")
    t = Trainer(cfg, prepare_datasets(cfg, root=root), device="cpu")
    t.init_state()
    batches = iter(t.train_batches(0))
    losses = [float(t.train_step(t.device_batch(next(batches), is_train=True)))
              for _ in range(2)]
    assert all(np.isfinite(losses))
