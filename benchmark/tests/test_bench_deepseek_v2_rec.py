"""The ``deepseek-v2-lite-rec.train-long`` cell on the CPU: it resolves to its
files at the published widths; the harness's run at a tiny size (the
configuration's ``cpu_test_sizes``, f32) agrees with the plain reference;
each fault planted in the port (top-5, the shared experts dropped, the
top-k weights renormalised, the rope left off q_pe) turns ``correct``
false, and so do the cell's own control and faults (the reference's,
half of every batch left out among them); ``arith_moe`` matches shapes
worked by hand; and each new reader gives its value on a hand-made trace,
None without its work, and 0.0 and a log line where its probe, counter or
spans are absent.

On the CPU the port computes in f32 what the reference computes, so the
program's numbers are rounding (under 1e-5); the faults are judged by
limits of 1e-4 here. The card's limits (``limits/``) sit above the bf16
program's readings and below the fp8 control's and the faults' (PERF.md).
"""

import os

import numpy as np
import pytest
import torch

import arith
import arith_moe
import harness
from conftest import tiny

CELL = "deepseek-v2-lite-rec.train-long"
SEED = 2**31 + 777
WIDTHS = {"hidden_size": 2048, "num_attention_heads": 16, "qk_nope_head_dim": 128,
          "qk_rope_head_dim": 64, "v_head_dim": 128, "kv_lora_rank": 512,
          "n_routed_experts": 64, "num_experts_per_tok": 6, "moe_intermediate_size": 1408,
          "n_shared_experts": 2, "intermediate_size": 10944, "num_hidden_layers": 27,
          "vocab_size": 102400, "num_items": 102400}


def test_cell_resolves_at_the_published_widths(bench_path):
    spec = harness.load_spec(CELL, bench_path)
    assert spec.traffic["entry"] == "moe_train" and spec.workload["chips"] == 1
    assert {k: spec.config[k] for k in WIDTHS} == WIDTHS
    assert spec.config["n_routed_experts_held"] == 8 and spec.config["expert_offset"] == 0
    assert spec.config["fold_foreign_experts"] is True
    assert set(spec.config["reduced"]) == {"n_routed_experts_held", "fold_foreign_experts",
                                           "tie_word_embeddings", "seq_aux"}
    assert {"data", "weights", "tied_table", "aux_loss"} <= set(spec.config["assumed"])
    assert spec.config["train"]["precision"] == "bf16" and spec.config["model"]["remat"]
    assert spec.config["data"]["max_seq_len"] == 200
    assert {m["name"] for m in spec.end_to_end} == {"setup_s", "train_seq_per_s"}
    assert {m["name"] for m in spec.per_layer} == {
        "mfu.moe", "expert_gemm_roofline.moe", "mla_attn_fwd_roofline.moe",
        "mla_attn_bwd_roofline.moe", "expert_load_max.moe", "moe_idle_share.moe",
        "idle_share.moe", "launches_per_step.train", "feed_idle_share.train",
        "feed_host_ms.train"}
    assert set(spec.limits) == {"loss_gap", "grad_gap", "update_gap", "serve_gap"}


FAULT_LIMITS = {"loss_gap": 1e-4, "grad_gap": 1e-4, "update_gap": 1e-4, "serve_gap": 1e-4}


def _run(bench_path, limits=None, control=False):
    spec = tiny(harness.load_spec(CELL, bench_path))
    if limits is not None:
        spec.limits = limits
    return harness.run_cell(spec, SEED, 0.3, False, device="cpu", control=control)


def test_agrees_with_reference(bench_path):
    result = _run(bench_path)
    assert result["correct"], result["checks"]
    assert all(c["value"] <= 1e-5 for c in result["checks"].values()), result["checks"]
    assert result["attempted"] > 0 and result["failed"] == 0
    assert {"setup_s", "train_seq_per_s"} == set(result["metrics"])


def _moe_init(monkeypatch, change):
    from dr4sr_tpu_torch.modules import moe

    init = moe.DeepSeekMoE.__init__

    def planted(self, *args, **kwargs):
        init(self, *args, **kwargs)
        change(self)

    monkeypatch.setattr(moe.DeepSeekMoE, "__init__", planted)


def _top5(monkeypatch):
    _moe_init(monkeypatch, lambda layer: setattr(layer, "top_k", layer.top_k - 1))


def _no_shared(monkeypatch):
    _moe_init(monkeypatch, lambda layer: setattr(layer.shared, "forward", lambda x: x * 0))


def _renormalised(monkeypatch):
    _moe_init(monkeypatch, lambda layer: setattr(layer, "norm_topk_prob", True))


def _no_rope_q(monkeypatch):
    from dr4sr_tpu_torch.modules import mla

    rotate = mla.rotate_pairs
    # q_pe has a head axis of all the heads, k_pe one shared head
    monkeypatch.setattr(mla, "rotate_pairs",
                        lambda x, cos, sin: x.float() if x.shape[-2] > 1 else rotate(x, cos, sin))


@pytest.mark.parametrize("plant", [_top5, _no_shared, _renormalised, _no_rope_q],
                         ids=lambda p: p.__name__.strip("_"))
def test_fault_turns_correct_false(plant, monkeypatch, bench_path):
    plant(monkeypatch)
    result = _run(bench_path, FAULT_LIMITS)
    assert not result["correct"], result["checks"]


def test_control_and_faults_read_not_correct(bench_path):
    """The cell's control (fp8 operands) and its faults in the reference,
    half of every batch left out among them, each judged as the program
    is, read not correct; the program reads correct."""
    result = _run(bench_path, FAULT_LIMITS, control=True)
    assert result["correct"], result["checks"]
    assert set(result["controls"]) == {"control_fp8", "fault_top5", "fault_no_shared",
                                       "fault_renormalised", "fault_no_rope_q",
                                       "fault_half_batch"}
    for name, judged in result["controls"].items():
        assert not judged["correct"], (name, judged["checks"])


def test_arith_moe_by_hand():
    m = {"hidden_size": 4, "num_attention_heads": 1, "qk_nope_head_dim": 2,
         "qk_rope_head_dim": 2, "v_head_dim": 2, "kv_lora_rank": 2, "num_hidden_layers": 2,
         "first_k_dense_replace": 1, "intermediate_size": 3, "n_routed_experts": 5,
         "moe_intermediate_size": 2, "n_shared_experts": 1, "n_routed_experts_held": 2}
    # MLA a position: q 4->4, kv_a 4->2+2, o 2->4 from the hidden 4; kv_b 2->4
    mla = 2 * 4 * (1 * 4 + 2 + 2 + 1 * 2) + 2 * 2 * 1 * (2 + 2)
    assert arith_moe.mla_token_flops(m) == mla == 96
    per_token = 2 * mla + 6 * 4 * 3 + (2 * 4 * 5 + 6 * 4 * 2) + 2 * 4 * 2
    pairs = 3 + 1  # lengths 2 and 1: 3 causal pairs and 1
    attention = 2 * 2 * (4 + 2) * pairs
    routed = 6 * 4 * 2 * 7
    want = 3.0 * (3 * per_token + attention + routed)
    assert arith_moe.step_flops(np.array([2, 1]), m, 7) == want
    keys = np.array([[True, True, False]])  # causal: 1 + 2 + 2 unmasked pairs
    fwd = arith_moe.attention_fwd_bound_s(1, 1, 3, 3, 4, 2, keys, True)
    assert fwd == max((2 * (3 * 4 + 3 * 4 + 3 * 2 + 3 * 2) + 3) / arith.PEAK_BYTES_PER_S,
                      2 * 6 * 5 / arith.PEAK_FLOPS_BF16)
    bwd = arith_moe.attention_bwd_bound_s(1, 1, 3, 3, 4, 2, keys, True)
    assert bwd == max((2 * (24 + 24 + 12 + 12) + 12 + 3) / arith.PEAK_BYTES_PER_S,
                      2 * (12 + 4) * 5 / arith.PEAK_FLOPS_BF16)
    gemm = arith_moe.expert_gemm_bound_s(m, 10, 3)
    assert gemm == max(2 * (2 * 3 * 3 * 2 * 4 * 2 + 3 * 10 * (8 + 6)) / arith.PEAK_BYTES_PER_S,
                       3 * 6 * 4 * 2 * 10 / arith.PEAK_FLOPS_BF16)


class Event:
    def __init__(self, name, start, end, cuda=False):
        self.name = name
        self.device_type = torch.autograd.DeviceType.CUDA if cuda else torch.autograd.DeviceType.CPU
        self.time_range = type("Range", (), {"start": start, "end": end})
        self.is_user_annotation = False


class Profile:
    def __init__(self, events):
        self._events = events

    def events(self):
        return self._events


PROBED = {"attention_fwd": frozenset({"flash_fwd_kernel<bf16, 192, 128>"}),
          "attention_bwd": frozenset({"flash_bwd_kernel<bf16, 192, 128, 2>"}),
          "moe_experts": frozenset({"sm90_grouped_gemm", "elementwise_silu"})}
WORK = {"train_steps": 2, "flops": 2e12, "attn_fwd_bound_s": 5e-5, "attn_bwd_bound_s": 1e-4,
        "expert_gemm_bound_s": 2e-4, "expert_assignments": [10, 30, 20, 20]}


def _trace(work, probed=PROBED, spans=True):
    """Two steps' worth: attention forward, a grouped product under the span
    moe.experts with an idle gap inside moe.route, the backward."""
    events = [Event("flash_fwd_kernel<bf16, 192, 128>", 0.0, 100.0, cuda=True),
              Event("sm90_grouped_gemm", 300.0, 700.0, cuda=True),
              Event("elementwise_silu", 700.0, 800.0, cuda=True),
              Event("flash_bwd_kernel<bf16, 192, 128, 2>", 1000.0, 1200.0, cuda=True)]
    if spans:
        events += [Event("moe.route", 50.0, 300.0), Event("moe.experts", 300.0, 800.0),
                   Event("moe.combine", 800.0, 900.0)]
    return harness.Trace(Profile(events), 2.0, work, probed)


def read(name, trace):
    path = os.path.join(harness.HERE, "metrics", name + ".py")
    return harness.load_module(path, "t_" + name.replace(".", "_")).read(trace)


def test_new_readers_on_a_hand_made_trace():
    t = _trace(WORK)
    assert read("mfu.moe", t) == pytest.approx(100 * 2e12 / (2.0 * arith.PEAK_FLOPS_BF16))
    assert read("mla_attn_fwd_roofline.moe", t) == pytest.approx(50.0)
    assert read("mla_attn_bwd_roofline.moe", t) == pytest.approx(50.0)
    # the grouped GEMM kernel counts; the probe's elementwise kernel does not
    assert read("expert_gemm_roofline.moe", t) == pytest.approx(50.0)
    assert read("expert_load_max.moe", t) == pytest.approx(150.0)
    # idle inside the spans: 100..300 (moe.route), 800..900 (moe.combine)
    assert read("moe_idle_share.moe", t) == pytest.approx(100 * 300e-6 / 2.0)
    assert read("idle_share.moe", t) == pytest.approx(100 * (1 - 800e-6 / 2.0))


@pytest.mark.parametrize("name", ["mfu.moe", "expert_gemm_roofline.moe",
                                  "mla_attn_fwd_roofline.moe", "mla_attn_bwd_roofline.moe",
                                  "expert_load_max.moe", "moe_idle_share.moe", "idle_share.moe"])
def test_new_readers_read_none_without_their_work(name):
    assert read(name, _trace({})) is None


def test_absent_counter_probe_and_spans(capsys):
    """A program without the load counter (no ``expert_assignments`` and no
    expert bound), a run without the experts' probe, and a trace without
    the spans: each reader gives 0.0 and says what was missing."""
    work = {k: v for k, v in WORK.items()
            if k not in ("expert_assignments", "expert_gemm_bound_s")}
    assert read("expert_load_max.moe", _trace(work)) == 0.0
    assert read("expert_gemm_roofline.moe", _trace(work)) == 0.0
    no_probe = {k: v for k, v in PROBED.items() if k != "moe_experts"}
    assert read("expert_gemm_roofline.moe", _trace(WORK, no_probe)) == 0.0
    assert read("moe_idle_share.moe", _trace(WORK, spans=False)) == 0.0
    err = capsys.readouterr().err
    for said in ("counter moe.assignments not in this run", "no expert bound",
                 "no grouped product in the probe", "span moe.route not in this trace"):
        assert said in err
