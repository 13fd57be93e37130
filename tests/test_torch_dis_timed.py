"""The port's verbosity-2 path: `models.dis.dis_flow_timed` and `cli.main`
at the op-point form's default verbosity.

dis_flow_timed runs the stages of `dis_flow` one at a time (templates,
start parameters, GN, densification, TV per scale), on the same routes, so
its flow equals dis_flow's bit for bit — at op-2, at op-3 (whose finest
levels build their templates inside the large-level GN kernel) and with
the forward-backward merge. It prints the lines of the JAX package's
dis_flow_timed (the reference's oflow.cpp:297 format), with equal scale
and patch-count fields; the times differ."""

import dataclasses
import os
import re

import jax.numpy as jnp
import numpy as np
import pytest

from of_dis_tpu.models import dis as jdis
from of_dis_tpu.params import op_point_params as j_op_point_params
from of_dis_tpu.utils import io as jio
from of_dis_tpu_torch import cli, convert
from of_dis_tpu_torch.models import dis as tdis
from of_dis_tpu_torch.utils import io as tio

G = os.path.join(os.path.dirname(__file__), "goldens")
NUM = re.compile(r"-?\d+(\.\d+)?(e[-+]?\d+)?")


def _pair(second="b.png"):
    return [jio.load_image(os.path.join(G, f)).astype(np.uint8)
            for f in ("a.png", second)]


def _params(op, **change):
    return dataclasses.replace(
        convert.params_from_reference(
            dataclasses.asdict(j_op_point_params(192, op))), **change)


def _shape(lines):
    """Each printed line with its numbers blanked (and the padding before
    them, which follows their size), and the (Sc, #p) fields of the
    per-scale lines."""
    text = [re.sub(r" +", " ", NUM.sub("#", ln)) for ln in lines]
    fields = [tuple(int(v) for v in re.findall(r"Sc: (\d+), #p: *(\d+)",
                                               ln)[0])
              for ln in lines if ln.startswith("TIME (Sc:")]
    return text, fields


@pytest.mark.parametrize("op,change", [(2, {}), (3, {}),
                                       (2, {"usefbcon": True})],
                         ids=["op2", "op3", "op2-fbcon"])
def test_timed_flow_equals_dis_flow(op, change, capsys):
    a, b = _pair()
    p = _params(op, **change)
    timed = tdis.dis_flow_timed(a, b, p, 192, 160, device="cpu")
    lines = capsys.readouterr().out.splitlines()
    flow = tdis.dis_flow(a, b, p, 192, 160, device="cpu")
    assert timed.shape == flow.shape
    np.testing.assert_array_equal(timed.numpy(), flow.numpy())
    np.testing.assert_array_equal(
        tdis.upscale_full(timed, p, 160, 192).numpy(),
        tdis.dis_flow_full(a, b, p, 192, 160, device="cpu").numpy())
    levels = list(range(p.sc_f, p.sc_l - 1, -1))
    assert _shape(lines)[1] == [
        (sl, tdis.make_level_spec(sl, 192, 160, p).nopatches)
        for sl in levels]


def test_timed_lines_match_the_jax_package(capsys):
    a, b = _pair()
    jp = j_op_point_params(192, 2)
    jdis.dis_flow_timed(jnp.asarray(a), jnp.asarray(b), jp, 192, 160)
    ref = capsys.readouterr().out.splitlines()
    tdis.dis_flow_timed(a, b, _params(2), 192, 160, device="cpu")
    ours = capsys.readouterr().out.splitlines()
    assert len(ref) == 2 + jp.sc_f - jp.sc_l + 1
    assert _shape(ours) == _shape(ref)


def test_timed_path_refuses_a_warm_start():
    a, b = _pair()
    with pytest.raises(NotImplementedError, match="item 14"):
        tdis.dis_flow_timed(a, b, _params(2), 192, 160,
                            init_flow=np.zeros((20, 24, 2), np.float32),
                            device="cpu")


@pytest.mark.parametrize("mode,second,suffix", [
    ("run_OF_INT", "b.png", ".flo"), ("run_DE_INT", "bs.png", ".pfm")])
def test_cli_verbosity_two_writes_the_quiet_output(tmp_path, capsys, mode,
                                                   second, suffix):
    """The op-point form runs at verbosity 2: the per-scale lines are
    printed, and the file equals the one written with --quiet."""
    files = [os.path.join(G, f) for f in ("a.png", second)]
    loud, quiet = (str(tmp_path / (n + suffix)) for n in ("loud", "quiet"))
    cli.main([mode, *files, loud, "2", "--device", "cpu"])
    out = capsys.readouterr().out
    cli.main([mode, *files, quiet, "2", "--quiet", "--device", "cpu"])
    assert capsys.readouterr().out == ""
    assert out.count("TIME (Sc: ") == 3 and "Pyramide+Gradients" in out
    read = tio.read_flo if suffix == ".flo" else tio.read_pfm
    np.testing.assert_array_equal(read(loud), read(quiet))
