"""On the card: each cell at its own size and window runs correct, and its
control (the reference in TF32 in the program's place, judged on as many
answers as a run judges) and each of its faults come out not correct, by
the expression that decides ``correct``.
``python -m pytest benchmark/tests -m bench_card`` on a machine with the
card (about 6 minutes); elsewhere these skip."""

import json
import os

import pytest

import harness

from conftest import ALL_CELLS

with open(os.path.join(harness.ROOT, "BENCHMARK.json")) as f:
    BENCH = json.load(f)


@pytest.mark.bench_card
@pytest.mark.parametrize("cell", ALL_CELLS)
def test_control_fails_where_the_program_passes(cell, card, bench_path):
    result = harness.run_cell(harness.load_spec(cell, bench_path), 2**31 + 99,
                              BENCH["run_seconds"], False, control=True)
    assert result["correct"], result["checks"]
    assert "control_tf32" in result["controls"]
    assert not any(c["correct"] for c in result["controls"].values()), result["controls"]
