"""The MoE layer's row kernels (``ops/moe_permute.py``, ``csrc/moe_permute.cu``)
on the card: against the plain chain, forward and backward, at D 256 and at
DeepSeek-V2-Lite's 2,048 with a third of the tokens masked; NaN planted in
every row past the last group reaching no output or gradient of the layer;
the layer's gradients the same bits over two runs; the launch counters
rising by one a kernel call, forward, remat's second forward and backward.

Marked ``card``: each skips without one. They import no JAX and read no
fixture of ``conftest.py``; on a card's machine, which has no JAX, run them
as

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_moe_permute_card.py -q
"""

import pytest
import torch
import torch_moe_rows

from dr4sr_tpu_torch.models.base import RecModel
from dr4sr_tpu_torch.models.deepseek_v2 import DeepSeekV2Rec
from dr4sr_tpu_torch.modules import moe
from dr4sr_tpu_torch.modules.moe import DeepSeekMoE
from dr4sr_tpu_torch.ops.moe_permute import (combine_rows, combine_rows_plain, dispatch_rows,
                                             dispatch_rows_plain)

pytestmark = pytest.mark.card


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


def _slot_sum(rows, back, k, live):
    """Each token's live rows summed in f32 in slot order, as the kernel sums."""
    padded = torch.cat([rows.float(), rows.new_zeros(1, rows.shape[1], dtype=torch.float32)])
    acc = torch.zeros(back.numel() // k, rows.shape[1], device=rows.device)
    for j in range(k):
        slot = back[j::k]
        acc = acc + padded[torch.where(slot < live, slot, rows.shape[0])]
    return acc


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("n,d", [(4096, 256), (4096, 2048)])
def test_kernels_against_the_plain_chain(card, n, d, dtype):
    k, held = 6, 8
    order, back, ends = torch_moe_rows.routing(n, k, held, seed=d, device=card)
    live = int(ends[-1])
    assert 0 < live < n * k
    gen = torch.Generator(device=card).manual_seed(1)
    x = torch.randn(n, d, device=card, generator=gen, requires_grad=True)
    ys = torch.randn(n * k, d, device=card, generator=gen).to(dtype)
    ys[live:] = float("nan")
    ys.requires_grad_()
    dxs = torch.randn(n * k, d, device=card, generator=gen).to(dtype)
    dxs[live:] = float("nan")
    dy = torch.randn(n, d, device=card, generator=gen)

    xs = dispatch_rows(x, order, back, k, ends, dtype)
    y = combine_rows(ys, back, k, ends)
    dx, = torch.autograd.grad(xs, x, dxs)
    dys, = torch.autograd.grad(y, ys, dy)

    xp, yp = x.detach().clone().requires_grad_(), ys.detach().clone().requires_grad_()
    xs_plain = dispatch_rows_plain(xp, order, k, ends, dtype)
    y_plain = combine_rows_plain(yp, back, k, ends)
    dys_plain, = torch.autograd.grad(y_plain, yp, dy)
    # the plain dispatch's backward sums in f32 here (atomics, any order):
    # the kernel's f32 sum within f32 rounding of it
    dx_plain, = torch.autograd.grad(dispatch_rows_plain(xp, order, k, ends, torch.float32),
                                    xp, dxs.float().nan_to_num(0.0))

    assert xs.dtype == dtype and torch.equal(xs[:live], xs_plain[:live])
    assert torch.equal(y, _slot_sum(ys.detach(), back, k, live))
    torch.testing.assert_close(y, y_plain, rtol=1e-6, atol=1e-6)
    assert dx.dtype == x.dtype and torch.equal(dx, _slot_sum(dxs, back, k, live))
    torch.testing.assert_close(dx, dx_plain, rtol=1e-6, atol=1e-6)
    assert dys.dtype == dtype and torch.equal(dys[:live], dys_plain[:live])


def _layer_run(layer, x, mask, seen=None, plant=False):
    """Output and every gradient (x's, the weights') of one bf16 forward and
    backward, NaN planted past the last group when ``plant``."""
    original = moe.grouped_swiglu
    if seen is not None:
        moe.grouped_swiglu = torch_moe_rows.planted_grouped_swiglu(original, seen, plant)
    try:
        x = x.detach().clone().requires_grad_()
        layer.zero_grad(set_to_none=True)
        with torch.autocast("cuda", dtype=torch.bfloat16):
            y = layer(x, mask)
        y.float().pow(2).mean().backward()
    finally:
        moe.grouped_swiglu = original
    return y.detach(), {"x": x.grad, **{k: p.grad for k, p in layer.named_parameters()}}


def _layer(card, d, fold, width=128):
    gen = torch.Generator().manual_seed(d)
    return DeepSeekMoE(d, 64, 6, width, 2, 8, 0, False, 1.0, gen, fold_foreign=fold).to(card)


def _inputs(card, n, d):
    gen = torch.Generator(device=card).manual_seed(n)
    x = torch.randn(n, d, device=card, generator=gen)
    return x, torch.rand(n, device=card, generator=gen) >= 1 / 3


@pytest.mark.parametrize("fold", [False, True])
def test_rows_past_the_last_group_reach_no_output_or_gradient(card, fold):
    layer = _layer(card, 256, fold)
    x, mask = _inputs(card, 2048, 256)
    seen = []
    y0, g0 = _layer_run(layer, x, mask, seen, plant=False)
    y1, g1 = _layer_run(layer, x, mask, seen, plant=True)
    assert all(0 < int(e[-1]) < 2048 * 6 for e in seen)
    assert torch.isfinite(y1).all() and torch.equal(y0, y1)
    for k in g0:
        assert torch.isfinite(g1[k]).all() and torch.equal(g0[k], g1[k]), k


def test_gradients_the_same_bits_over_two_runs(card):
    layer = _layer(card, 2048, True, width=1408)
    x, mask = _inputs(card, 4096, 2048)
    (y0, g0), (y1, g1) = _layer_run(layer, x, mask), _layer_run(layer, x, mask)
    assert torch.equal(y0, y1)
    for k in g0:
        assert torch.equal(g0[k], g1[k]), k


def test_launch_counters_rise_per_layer_call(card):
    """A layer's forward launches each kernel once and its backward once
    more; a remat step of a model with two MoE layers three times each."""
    layer = _layer(card, 256, True)
    x, mask = _inputs(card, 512, 256)
    x.requires_grad_()
    before = (dispatch_rows.launches, combine_rows.launches)
    with torch.autocast("cuda", dtype=torch.bfloat16):
        y = layer(x, mask)
    assert (dispatch_rows.launches, combine_rows.launches) == (before[0] + 1, before[1] + 1)
    y.float().sum().backward()
    assert (dispatch_rows.launches, combine_rows.launches) == (before[0] + 2, before[1] + 2)

    m = dict(hidden_size=256, num_hidden_layers=3, first_k_dense_replace=1,
             intermediate_size=512, num_attention_heads=2, qk_nope_head_dim=128,
             qk_rope_head_dim=64, v_head_dim=128, kv_lora_rank=64, rms_norm_eps=1e-6,
             rope_theta=10000, rope_scaling=dict(type="yarn", factor=40,
                                                 original_max_position_embeddings=4096,
                                                 beta_fast=32, beta_slow=1, mscale=0.707,
                                                 mscale_all_dim=0.707),
             n_routed_experts=16, n_routed_experts_held=4, expert_offset=4,
             num_experts_per_tok=6, moe_intermediate_size=128, n_shared_experts=2,
             norm_topk_prob=False, routed_scaling_factor=1.0, remat=True, loss_fn="bce")
    cfg = {"model": m, "train": {"precision": "bf16"}, "data": {"max_seq_len": 50}}
    module = DeepSeekV2Rec.build(cfg, 100, generator=torch.Generator().manual_seed(1)).to(card)
    seq = torch.randint(1, 100, (4, 50), device=card)
    seq[1, 20:] = 0
    batch = {"in_item_id": seq, "seqlen": torch.tensor([50, 20, 50, 50], device=card),
             "item_id": seq, "valid": torch.ones(4, dtype=torch.bool, device=card)}
    neg = torch.randint(1, 100, (4, 50, 1), device=card)
    before = (dispatch_rows.launches, combine_rows.launches)
    RecModel(cfg, module, 100, 10).training_loss(batch, None, neg_id=neg).backward()
    moe_layers = m["num_hidden_layers"] - m["first_k_dense_replace"]
    assert (dispatch_rows.launches - before[0], combine_rows.launches - before[1]) == (
        3 * moe_layers, 3 * moe_layers)
