"""Tests of the benchmark: on the CPU at tiny sizes, and on the card.

Registers the ``bench_card`` marker: such a test decides inside itself
whether a card is there and skips without one. ``tiny`` shrinks a cell's
scale and traffic (never its widths) to what a CPU test holds. The cells
of ``held.json`` are tested as the benchmark's own are: ``bench_path`` is
a ``BENCHMARK.json`` that holds both, for ``harness.load_spec``.
"""

import json
import os
import sys

import pytest

BENCH = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ROOT = os.path.dirname(BENCH)
sys.path.insert(0, BENCH)
sys.path.insert(1, ROOT)

TINY_SCALE = {"num_users": 40, "num_items": 30, "num_interactions": 320, "num_pairs": 300}
TINY_TRAFFIC = {"histories_per_request": 8, "request_pool": 50, "warmup_requests": 2,
                "checked_requests": 4, "batch_size": 16, "checked_lanes_per_call": 4,
                "check_block": 8, "steps_per_dispatch": 2}


def with_held() -> dict:
    """``BENCHMARK.json`` with the cells and metrics of ``held.json`` added."""
    with open(os.path.join(ROOT, "BENCHMARK.json")) as f:
        bench = json.load(f)
    with open(os.path.join(BENCH, "held.json")) as f:
        held = json.load(f)
    for key in ("workloads", "end_to_end", "per_layer"):
        bench[key] = bench[key] + held[key]
    return bench


ALL_CELLS = [w["name"] for w in with_held()["workloads"]]


def pytest_configure(config):
    config.addinivalue_line("markers", "bench_card: needs a CUDA card; skips without one")


def tiny(spec):
    """``spec`` with the scale and the traffic cut to a CPU test's size."""
    spec.config.update({k: v for k, v in TINY_SCALE.items() if k in spec.config})
    if "batch_size" in spec.config.get("train", {}):
        spec.config["train"]["batch_size"] = 8
    spec.traffic.update({k: v for k, v in TINY_TRAFFIC.items() if k in spec.traffic})
    return spec


@pytest.fixture
def card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.cuda.get_device_name()


@pytest.fixture(scope="session")
def bench_path(tmp_path_factory):
    path = tmp_path_factory.mktemp("bench") / "BENCHMARK.json"
    path.write_text(json.dumps(with_held()))
    return str(path)
