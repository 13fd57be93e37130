"""The port's tensor-core dot microbenchmark (T1, `kernels.i8_dot`, its
tool `of_dis_tpu_torch.tools.bench_i8_dot`) against the JAX package's
tools/bench_i8_dot.py, whose Pallas kernel runs in interpret mode on the
CPU in a child process (the tool sets process-wide JAX options).

Every operand is a small integer, so both products are exact: the port's
plain twin equals the JAX kernel's output, int8 and bf16 alike, with no
tolerance. The card's kernel is held against the twin in
tests/test_torch_kernels_cuda.py."""

import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from of_dis_tpu_torch import trace
from of_dis_tpu_torch.kernels import build, i8_dot
from of_dis_tpu_torch.tools import bench_i8_dot

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ARGV = ["2", "1", "32", "64", "16"]     # reps, grid, m, k, n

# Runs a JAX tool with every pallas_call interpreted and jax.jit the
# identity (the tool's calls then see arrays), and saves the output of
# every kernel call, in call order, to an .npz.
CHILD = r"""
import os, runpy, sys
import numpy as np
import jax
jax.config.update("jax_platforms", "cpu")
from jax.experimental import pallas as pl
tool, out, argv = sys.argv[1], sys.argv[2], sys.argv[3:]
outs = []
orig = pl.pallas_call
def pallas_call(*args, **kw):
    fn = orig(*args, **{**kw, "interpret": True})
    def call(*a, **k):
        o = fn(*a, **k)
        outs.append(np.asarray(o))
        return o
    return call
pl.pallas_call = pallas_call
jax.jit = lambda f=None, *a, **k: f if f is not None else (lambda g: g)
sys.argv = [tool] + argv
runpy.run_path(tool, run_name="__main__")
np.savez(out, *outs)
"""


def run_jax_tool(tool: str, argv, tmp_path, env=None) -> list:
    """The outputs of every kernel call of tools/<tool> run with argv."""
    out = tmp_path / "outs.npz"
    r = subprocess.run(
        [sys.executable, "-c", CHILD, os.path.join(ROOT, "tools", tool),
         str(out)] + list(argv),
        cwd=ROOT, capture_output=True, text=True, timeout=600,
        env=dict(os.environ, JAX_PLATFORMS="cpu", **(env or {})))
    assert r.returncode == 0, r.stderr[-3000:]
    with np.load(out) as z:
        return [z[f"arr_{i}"] for i in range(len(z.files))]


@pytest.fixture(scope="module")
def jax_outs(tmp_path_factory):
    return run_jax_tool("bench_i8_dot.py", ARGV,
                        tmp_path_factory.mktemp("i8_dot"))


@pytest.mark.parametrize("dtype,call", [(torch.bfloat16, 0),
                                        (torch.int8, 2)])
def test_twin_equals_the_jax_kernel(jax_outs, dtype, call):
    """The JAX tool calls each kernel twice (a check, then the timed
    call): bf16 first, then int8; every program writes the one block."""
    reps, grid, m, k, n = map(int, ARGV)
    a, bt = bench_i8_dot.make_inputs(reps, m, k, n, "cpu")[dtype]
    ours = i8_dot.dot_sum(a, bt, n, grid)
    assert ours.shape == (grid, m, n)
    for ref in jax_outs[call:call + 2]:
        assert ref.shape == (m, n)
        for g in range(grid):
            np.testing.assert_array_equal(ours[g].numpy(), ref)


def test_twin_equals_the_int64_product():
    reps, m, k, n = 3, 20, 48, 8
    x = bench_i8_dot.make_inputs(reps, m, k, n, "cpu")
    a, bt = (t.numpy().astype(np.int64) for t in x[torch.int8])
    want = sum(a @ bt[n * i:n * i + n].T for i in range(reps))
    for dtype in (torch.int8, torch.bfloat16):
        out = i8_dot.dot_sum(*x[dtype], n, 2)
        assert out.dtype == i8_dot.ACC[dtype]
        for g in range(2):
            np.testing.assert_array_equal(out[g].numpy().astype(np.int64),
                                          want)


def test_tool_on_the_cpu_runs_the_twin_and_counts_nothing(capsys):
    before = trace.launches("i8_dot")
    res = bench_i8_dot.main(ARGV + ["--device", "cpu"])
    assert trace.launches("i8_dot") == before and not build._libs
    a = res["int8 -> int32"]["out"]
    np.testing.assert_array_equal(a.numpy(),
                                  res["bf16 -> f32"]["out"].numpy())
    out = capsys.readouterr().out
    assert "int8 -> int32:" in out and "i8 speedup over bf16:" in out


def test_wrapper_rejects_mixed_or_misshapen_operands():
    a = torch.zeros((4, 16), dtype=torch.int8)
    with pytest.raises(ValueError, match="int8 or both bfloat16"):
        i8_dot.dot_sum(a, torch.zeros((8, 16), dtype=torch.bfloat16), 8, 1)
    with pytest.raises(ValueError, match=r"bt \(reps n, k\)"):
        i8_dot.dot_sum(a, torch.zeros((9, 16), dtype=torch.int8), 8, 1)
