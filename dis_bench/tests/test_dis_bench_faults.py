"""A whole run on the CPU (the look for a card skipped, small frames,
a quarter of each batch checked) with the timed path broken underneath:
`correct` comes out false for each fault a cell can have, and true for
the sound path. The sample at the cells' own sizes covers every part of
the batch, so the same faults are seen there on every seed."""

import numpy as np
import pytest
import torch

from dis_bench import loops, run
from of_dis_tpu_torch.models import dis

BENCH = run.load_json(run.ROOT / "BENCHMARK.json")
BATCH = "dis_op2_gray.sintel_b256"
STREAM = "dis_op2_gray.sintel_stream256"


@pytest.fixture(autouse=True)
def one_thread():
    n = torch.get_num_threads()
    yield
    torch.set_num_threads(n)


def small_run(workload, seed=3000000007):
    cell = run.find_cell(BENCH, workload)
    traffic = run.load_json(run.HERE / "traffic" / f"{cell['traffic']}.json")
    traffic.update(height=60, width=96)
    if traffic["kind"] == "batch":
        traffic.update(batch=8, check_pairs=2, ref_block=2)
    else:
        traffic.update(streams=8, frames=4, check_streams=2, check_steps=4,
                       ref_block=2)
    return run.run_cell(BENCH, cell, seed, 0.5, False, device="cpu",
                        traffic=traffic)


@pytest.mark.parametrize("cell", BENCH["workloads"],
                         ids=[c["name"] for c in BENCH["workloads"]])
def test_the_cells_samples_cover_both_halves(cell):
    """At the committed sizes and sample counts, on 2,000 seeds: every
    range of batch / count (so each half) holds a sampled pair."""
    traffic = run.load_json(run.HERE / "traffic" / f"{cell['traffic']}.json")
    n = traffic.get("batch", traffic.get("streams"))
    k = traffic.get("check_pairs", traffic.get("check_streams"))
    assert 2 <= k < n
    for seed in range(3000000000, 3000002000):
        idx = loops.spread_sample(n, k, np.random.default_rng(seed))
        assert len(set(idx)) == k
        assert (np.arange(k) == idx * k // n).all()


def half_left_out(flow):
    """The second half of the batch not computed: the mean of the rest."""
    h = flow.shape[0] // 2
    flow = flow.clone()
    flow[h:] = flow[:h].mean(0)
    return flow


def altered(flow):
    """One answer altered where it is produced: a pixel off by 1 px."""
    flow = flow.clone()
    flow[:, 20, 30, 0] += 1.0
    return flow


@pytest.mark.parametrize("workload", [BATCH, STREAM])
def test_the_sound_path_is_correct(workload):
    out = small_run(workload)
    assert out["correct"], out["checks"]
    assert list(out["checks"])[-1] and list(out)[-1] == "checks"


@pytest.mark.parametrize("fault", [half_left_out, altered])
def test_a_broken_batch_is_not_correct(monkeypatch, fault):
    orig = dis.dis_flow_batched
    monkeypatch.setattr(dis, "dis_flow_batched",
                        lambda *a, **k: fault(orig(*a, **k)))
    assert not small_run(BATCH)["correct"]


@pytest.mark.parametrize("fault", [half_left_out, altered])
def test_a_broken_step_is_not_correct(monkeypatch, fault):
    orig = dis.dis_step_warm

    def step(*a, **k):
        flow, carry = orig(*a, **k)
        return fault(flow), carry

    monkeypatch.setattr(dis, "dis_step_warm", step)
    assert not small_run(STREAM)["correct"]


def test_a_step_that_returns_its_state_unchanged_is_not_correct(monkeypatch):
    orig = dis.dis_step_warm

    def step(im_a, im_b, params, w, h, carry, **k):
        flow, _ = orig(im_a, im_b, params, w, h, carry, **k)
        return flow, carry

    monkeypatch.setattr(dis, "dis_step_warm", step)
    out = small_run(STREAM)
    assert not out["correct"], out["checks"]
