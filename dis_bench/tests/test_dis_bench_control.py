"""The control on the card: the reference put in the program's place and
computed with TF32 matrix products comes out as not correct under every
cell's limits, while the program, on the same sample, comes out correct.
Each cell's own frames and entry at a batch (or stream count) that a test
run holds; `python -m dis_bench.control` reads the same at the cells'
own sizes. Marked `cuda`: it skips without a card.

    python -m pytest -m cuda dis_bench/tests/test_dis_bench_control.py
"""

import pytest
import torch

from dis_bench import control, run

pytestmark = pytest.mark.cuda
BENCH = run.load_json(run.ROOT / "BENCHMARK.json")


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the control measures TF32 "
                    "matrix products, which only the card has")


def over(readings, limits):
    return [k for k, v in readings.items() if v > limits[k]]


@pytest.mark.parametrize("workload", [c["name"] for c in BENCH["workloads"]])
@pytest.mark.parametrize("seed", [3200000001, 3200000002, 3200000003])
def test_the_control_is_not_correct(card, workload, seed):
    cell = run.find_cell(BENCH, workload)
    traffic = run.load_json(run.HERE / "traffic" / f"{cell['traffic']}.json")
    if traffic["kind"] == "batch":
        traffic.update(batch=min(traffic["batch"], 8), check_calls=1)
    else:
        traffic.update(streams=4, check_streams=2, check_steps=3)
    limits = run.load_json(run.HERE / "limits" / f"{workload}.json")
    got = control.readings(cell, seed, 1.0, True, traffic=traffic)
    assert not over(got["program"], limits), got
    assert over(got["control"], limits), got
