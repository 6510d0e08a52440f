"""The per-layer readers and the trace's reduction, on a hand-made trace:
each reader returns its value where the work it counts is there, and
None (never 0) where it is not."""

import json
import os

import pytest

import arith
import harness


class Event:
    """A profiler event as ``torch.profiler`` hands it over."""

    def __init__(self, name, start, end, cuda=False):
        import torch

        self.name = name
        self.device_type = torch.autograd.DeviceType.CUDA if cuda else torch.autograd.DeviceType.CPU
        self.time_range = type("Range", (), {"start": start, "end": end})
        self.is_user_annotation = False


class Profile:
    def __init__(self, events):
        self._events = events

    def events(self):
        return self._events


PROBED = {"attention_fwd": frozenset({"flash_fwd_kernel<float, 32>"}),
          "attention_bwd": frozenset({"flash_bwd_kernel<float, 32, 0>"})}


def trace(work, probed=PROBED):
    """A step: the attention forward, a product, the attention backward,
    each one launch and one kernel."""
    return harness.Trace(Profile([
        Event("bench.unit", 0.0, 2000.0), Event("aten::addmm", 500.0, 900.0),
        Event("cudaLaunchKernel", 10.0, 11.0), Event("cudaLaunchKernel", 501.0, 502.0),
        Event("cudaGraphLaunch", 951.0, 952.0),
        Event("flash_fwd_kernel<float, 32>", 0.0, 100.0, cuda=True),
        Event("gemm", 50.0, 400.0, cuda=True),
        Event("flash_bwd_kernel<float, 32, 0>", 1000.0, 1300.0, cuda=True)]), 2.0, work, probed)


WORK = {"train_steps": 8, "requests": 4, "decode_positions": 20, "flops": 1e12,
        "attn_fwd_bound_s": 5e-5, "attn_bwd_bound_s": 1.5e-4}
with open(os.path.join(harness.ROOT, "BENCHMARK.json")) as f:
    BENCH = json.load(f)
METRICS = [m["name"] for m in BENCH["per_layer"]]
CELLS = [w["name"] for w in BENCH["workloads"]]


def read(name, work):
    path = os.path.join(harness.HERE, "metrics", name + ".py")
    return harness.load_module(path, "t_" + name.replace(".", "_")).read(trace(work))


def test_union_and_breakdown():
    t = trace(WORK)
    assert t.busy == [(0.0, 400.0), (1000.0, 1300.0)]
    assert t.busy_s == pytest.approx(700e-6)
    assert t.breakdown()["idle_gaps"] == [["aten::addmm", pytest.approx(600e-6)]]
    assert t.launches == 3


def test_kernels_count_for_the_probe_that_launched_them():
    """A kernel counts for a probe by the names the probe launched, so a
    renamed kernel that the op launches counts, and no other."""
    t = trace(WORK)
    assert [k[0] for k in t.probed_kernels("attention_fwd")] == ["flash_fwd_kernel<float, 32>"]
    assert t.probed_device_s("attention_bwd") == pytest.approx(300e-6)
    renamed = trace(WORK, {"attention_fwd": frozenset({"gemm"})})
    assert renamed.probed_device_s("attention_fwd") == pytest.approx(350e-6)
    assert trace(WORK, {}).probed_kernels("attention_fwd") == []


def test_values():
    assert read("launches_per_step.train", WORK) == 3 / 8
    assert read("launches_per_step.regen", WORK) == 3 / 20
    assert read("device_ms.serve", WORK) == pytest.approx(1e3 * 700e-6 / 4)
    assert read("idle_share.serve", WORK) == pytest.approx(100 * (1 - 700e-6 / 2.0))
    assert read("mfu.train", WORK) == pytest.approx(100 * 1e12 / (2.0 * arith.PEAK_FLOPS_BF16))
    assert read("attn_fwd_roofline.train", WORK) == pytest.approx(50.0)
    assert read("attn_bwd_roofline.pretrain", WORK) == pytest.approx(50.0)


@pytest.mark.parametrize("name", METRICS)
def test_nothing_to_read_is_none(name):
    assert read(name, {}) is None


@pytest.mark.parametrize("cell", CELLS)
def test_a_listed_metric_that_reads_nothing_ends_the_run(cell):
    spec = harness.load_spec(cell)
    assert set(harness.read_per_layer(spec, trace(WORK))) == {m["name"] for m in spec.per_layer}
    with pytest.raises(SystemExit):
        harness.read_per_layer(spec, trace({}))
