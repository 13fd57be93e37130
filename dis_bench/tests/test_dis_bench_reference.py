"""The benchmark's reference against the port's plain path on the CPU, at
small sizes: both configurations, a batch and a chain of warm steps,
equal bit for bit (the reference is a frozen copy of that path)."""

import json
from pathlib import Path

import pytest
import torch

from dis_bench import geometry
from dis_bench.reference import dis_flow as ref
from dis_bench.traffic import synth
from of_dis_tpu_torch.models import dis
from of_dis_tpu_torch.params import op_point_params

HERE = Path(__file__).resolve().parents[1]
# op-2 at 160 wide runs levels 3..1 (K1's route); op-4 at 96 wide levels
# 1..0, level 0 with 640 patches on K6's route
SIZES = {"dis_op2_gray": (120, 160), "dis_op4_gray": (60, 96)}


def config(name):
    return json.loads((HERE / "configs" / f"{name}.json").read_text())


@pytest.fixture(autouse=True)
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.mark.parametrize("width", [1024, 1920, 160, 96])
@pytest.mark.parametrize("name", sorted(SIZES))
def test_config_is_the_ports_op_point(name, width):
    """Every parameter, the coarsest and finest scales with them, at the
    cells' width, at 1920 (where the coarsest scale is one higher) and at
    the tests' small widths."""
    cfg = config(name)
    ours = geometry.params_for(cfg, width)
    port = op_point_params(width, cfg["op_point"])
    for f in ("sc_f", "sc_l") + geometry.PARAM_KEYS:
        assert getattr(ours, f) == getattr(port, f), f


def pairs(name, n, seed):
    cfg = config(name)
    h, w = SIZES[name]
    params = geometry.params_for(cfg, w)
    fh, fw = geometry.padded_size(h, w, params.sc_f + 1)
    a, b = synth.make_pairs(n, h, w, synth.generator(seed, "cpu"), "cpu",
                            fh, fw)
    return cfg, params, op_point_params(w, cfg["op_point"]), a, b, fh, fw


@pytest.mark.parametrize("name", sorted(SIZES))
def test_batch_equals_the_ports_plain_path(name):
    _, params, pp, a, b, fh, fw = pairs(name, 3, 2 ** 33 + 5)
    port = dis.dis_flow_batched(a, b, pp, fw, fh, device="cpu")
    ours = ref.flow(a, b, params)
    assert ours.shape == port.shape == (3, fh, fw, 2)
    assert torch.equal(ours, port)


@pytest.mark.parametrize("name", sorted(SIZES))
def test_warm_steps_equal_the_ports(name):
    _, params, pp, a, b, fh, fw = pairs(name, 2, 7)
    carry = dis.warm_carry_init(2, pp, fw, fh, device="cpu")
    ours = torch.zeros_like(carry)
    for x, y in ((a, b), (b, a), (a, b)):
        port, carry = dis.dis_step_warm(x, y, pp, fw, fh, carry,
                                        device="cpu")
        flow = ref.flow(x, y, params, ours)
        ours = ref.carry_of(flow, params.sc_f)
        assert torch.equal(flow, port)
        assert torch.equal(ours, carry)


def test_reference_refuses_what_it_does_not_compute():
    cfg = dict(config("dis_op2_gray"), noc=3)
    with pytest.raises(ValueError):
        ref.check_supported(geometry.params_for(cfg, 160))
