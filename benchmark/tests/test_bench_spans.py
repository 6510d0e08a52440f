"""The span readers (``spans.py`` and the ``metrics/`` files that use it) on
a hand-made trace of the port's spans and the device's kernels, each value
worked by hand; 0.0 where the work is there and the span is not (a program
without spans), None where the work is not."""

import os

import pytest

import harness
import spans
from test_bench_readers import Event, Profile

# the device busy over [0, 100], [300, 400], [700, 800], [1000, 1100] µs:
# idle gaps (100, 300), (400, 700), (800, 1000)
KERNELS = [Event(f"k{i}", s, s + 100.0, cuda=True) for i, s in enumerate((0.0, 300.0, 700.0,
                                                                        1000.0))]
SPANS = [
    Event("train.load", 50.0, 250.0),  # 150 µs of gap 1
    Event("train.stage", 250.0, 500.0),  # 50 of gap 1, 100 of gap 2
    Event("train.stage", 850.0, 900.0),  # 50 of gap 3
    Event("serve.batch", 120.0, 280.0),  # 160 of gap 1
    Event("serve.score", 280.0, 450.0),  # 20 of gap 1, 50 of gap 2
    Event("serve.fetch", 450.0, 1050.0),  # read by no metric
    Event("regen.position", 0.0, 100.0), Event("regen.position", 100.0, 200.0),
    Event("regen.position", 200.0, 300.0),  # 300 µs in all
    Event("regen.collect", 750.0, 1000.0),  # 200 of gap 3
]
OTHER = [Event("bench.unit", 0.0, 1100.0), Event("aten::addmm", 120.0, 200.0),
         Event("cudaLaunchKernel", 10.0, 11.0)]
WINDOW_S = 0.002
WORK = {"train_steps": 4, "requests": 2, "decode_positions": 3}

EXPECTED = {
    # 200 + 100 + 50 µs of the union (50, 500) ∪ (850, 900) in gaps, over 2 ms
    "feed_idle_share.train": 100 * 350e-6 / WINDOW_S,
    # (200 + 250 + 50) µs over 4 steps
    "feed_host_ms.train": 0.5 / 4,
    "batch_idle_share.serve": 100 * 160e-6 / WINDOW_S,
    "score_idle_share.serve": 100 * 70e-6 / WINDOW_S,
    # 300 µs over 3 positions
    "position_host_ms.regen": 0.3 / 3,
    "collect_idle_share.regen": 100 * 200e-6 / WINDOW_S,
}
SPAN_OF = {"feed_idle_share.train": "train.load", "feed_host_ms.train": "train.stage",
           "batch_idle_share.serve": "serve.batch", "score_idle_share.serve": "serve.score",
           "position_host_ms.regen": "regen.position",
           "collect_idle_share.regen": "regen.collect"}


def trace(events, work):
    return harness.Trace(Profile(events), WINDOW_S, work)


def read(name, t):
    path = os.path.join(harness.HERE, "metrics", name + ".py")
    return harness.load_module(path, "t_spans_" + name.replace(".", "_")).read(t)


def test_gaps_and_overlap():
    t = trace(KERNELS + SPANS + OTHER, WORK)
    assert spans.idle_gaps(t) == [(100.0, 300.0), (400.0, 700.0), (800.0, 1000.0)]
    assert spans.overlap([(0.0, 10.0), (20.0, 30.0)], [(5.0, 25.0), (29.0, 40.0)]) == 11.0
    assert spans.overlap([], [(0.0, 1.0)]) == 0.0


@pytest.mark.parametrize("name", sorted(EXPECTED))
def test_values(name):
    assert read(name, trace(KERNELS + SPANS + OTHER, WORK)) == pytest.approx(EXPECTED[name])


@pytest.mark.parametrize("name", sorted(EXPECTED))
def test_absent_span_reads_zero(name, capsys):
    assert read(name, trace(KERNELS + OTHER, WORK)) == 0.0
    assert f"span {SPAN_OF[name]} not in this trace" in capsys.readouterr().err


@pytest.mark.parametrize("name", sorted(EXPECTED))
def test_no_work_is_none(name):
    assert read(name, trace(KERNELS + SPANS + OTHER, {})) is None


def test_one_absent_span_of_two_still_reads_the_other(capsys):
    events = KERNELS + OTHER + [e for e in SPANS if e.name != "train.load"]
    t = trace(events, WORK)
    # the stage alone: 50 + 100 + 50 µs in gaps, 300 µs long
    assert read("feed_idle_share.train", t) == pytest.approx(100 * 200e-6 / WINDOW_S)
    assert read("feed_host_ms.train", t) == pytest.approx(0.3 / 4)
    assert "span train.load not in this trace" in capsys.readouterr().err
