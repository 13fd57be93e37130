"""T1: the tensor-core dot microbenchmark as one CUDA kernel
(csrc/i8_dot.cu: `wgmma` on operands that TMA streams into shared memory),
int8 -> int32 and bf16 -> float32, replacing the TPU kernel of
`tools/bench_i8_dot.py` of the JAX package.

Plain twin: `_plain` (float64 products, exact for these integer inputs)."""

from __future__ import annotations

import ctypes

import torch

from of_dis_tpu_torch.kernels import build

NAME = "i8_dot"

_i, _p = ctypes.c_int, ctypes.c_void_p
_ARGTYPES = [_p] * 3 + [_i] * 6 + [_p]
# operand type -> accumulator type
ACC = {torch.int8: torch.int32, torch.bfloat16: torch.float32}
# bytes of k a block keeps of A in shared memory, beside a ring of two or
# more 32 KB stages of B
MAX_K_BYTES = 1280


def _plain(a: torch.Tensor, bt: torch.Tensor, n: int, grid: int
           ) -> torch.Tensor:
    """The twin: float64 products of the integer-valued operands, exact
    below 2^53, summed over the repetitions, cast to the kernel's
    accumulator type and repeated for every g."""
    m = a.shape[0]
    reps = bt.shape[0] // n
    o = (a.double() @ bt.double().T).reshape(m, reps, n).sum(1)
    return o.to(ACC[a.dtype]).expand(grid, m, n).contiguous()


def dot_sum(a: torch.Tensor, bt: torch.Tensor, n: int, grid: int
            ) -> torch.Tensor:
    """out[g] = sum_i a @ bt[n i : n i + n].T for g < grid: a (m, k) and bt
    (reps n, k) — the right-hand side B (k, reps n) transposed — both int8
    (out int32) or both bf16 (out float32). Returns (grid, m, n). CPU
    tensors run the plain twin."""
    if a.dtype not in ACC or bt.dtype != a.dtype:
        raise ValueError(f"{NAME}: operands must both be int8 or both "
                         f"bfloat16, got {a.dtype} and {bt.dtype}")
    if a.ndim != 2 or bt.ndim != 2 or n < 1 or bt.shape[0] % n \
            or bt.shape[1] != a.shape[1]:
        raise ValueError(f"{NAME}: a must be (m, k) and bt (reps n, k) with "
                         f"n={n}, got {tuple(a.shape)} and "
                         f"{tuple(bt.shape)}")
    if a.device.type == "cpu":
        return _plain(a, bt, n, grid)
    m, k = a.shape
    if (k * a.element_size()) % 16 or k * a.element_size() > MAX_K_BYTES:
        raise ValueError(f"{NAME}: k * element size must be a multiple of "
                         f"16 bytes and at most {MAX_K_BYTES}, got k={k}")
    build.check_tensor(NAME, "a", a, (m, k), a.dtype)
    build.check_tensor(NAME, "bt", bt, tuple(bt.shape), a.dtype)
    out = torch.empty((grid, m, n), dtype=ACC[a.dtype], device=a.device)
    build.launch(a.device, NAME, "of_i8_dot", _ARGTYPES, build.ptr(a),
                 build.ptr(bt), build.ptr(out), m, k, n, bt.shape[0] // n,
                 grid, int(a.dtype == torch.bfloat16))
    return out
