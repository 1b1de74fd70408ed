"""The control: the reference in bfloat16 in the program's place fails
the cell's limits, here on small copies of the cells and, on the card, at
each cell's own size."""

import json

import pytest

from benchmark import harness
from benchmark.control import control_gaps
from bench_util import SMALL_CELLS, small_bench


@pytest.mark.parametrize("cell", sorted(SMALL_CELLS))
def test_control_fails_a_limit_small(root, cell):
    limits = harness.load_json(root, "limits", SMALL_CELLS[cell][2])
    gaps = control_gaps(cell, 2**31 + 99, small_bench(root), root=root,
                        device="cpu", frames_in_window=4)
    assert any(v > limits[k]["limit"] for k, v in gaps.items()), gaps


@pytest.mark.cuda
def test_control_fails_a_limit_on_the_card(cuda_device):
    with open(harness.BENCHMARK_JSON) as f:
        bench = json.load(f)
    for cell in bench["workloads"]:
        limits = harness.load_json(harness.HERE, "limits", cell["name"])
        for seed in (11, 2**31 + 12, 3 * 2**30 + 13):
            gaps = control_gaps(cell["name"], seed, bench,
                                device=cuda_device)
            assert any(v > limits[k]["limit"] for k, v in gaps.items()), \
                (cell["name"], seed, gaps)
