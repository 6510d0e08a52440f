"""``launches_per_request.serve`` on hand-made traces of a few requests:
an eager request counts each kernel launch, a replayed one its graph
launch; a trace without requests reads None."""

import pytest

import harness
from test_bench_readers import Event, Profile

NAME = "launches_per_request.serve"


def read(events, work):
    reader = harness.load_module(f"{harness.HERE}/metrics/{NAME}.py", "t_launches_serve")
    return reader.read(harness.Trace(Profile(events), 1.0, work))


def request(start, launch_calls):
    """One request: its span, its launch calls and one kernel."""
    return ([Event("bench.recommend", start, start + 100.0)]
            + [Event(name, start + 1.0 + i, start + 1.5 + i) for i, name in enumerate(launch_calls)]
            + [Event("gemm", start + 10.0, start + 20.0, cuda=True)])


EAGER = ["cudaLaunchKernel"] * 40 + ["cuLaunchKernel"] * 2 + ["cudaMemcpyAsync"]
GRAPHED = ["cudaGraphLaunch", "cudaMemcpyAsync"]


@pytest.mark.parametrize("calls,want", [(EAGER, 42.0), (GRAPHED, 1.0)], ids=["eager", "graphed"])
def test_launches_a_request(calls, want):
    events = [e for r in range(3) for e in request(200.0 * r, calls)]
    assert read(events, {"requests": 3}) == want


def test_a_mix_of_eager_and_graphed_requests():
    events = request(0.0, EAGER) + request(200.0, GRAPHED) + request(400.0, GRAPHED)
    assert read(events, {"requests": 3}) == pytest.approx(44 / 3)


def test_no_requests_is_none():
    assert read(request(0.0, GRAPHED), {}) is None
    assert read(request(0.0, GRAPHED), {"requests": 0}) is None
