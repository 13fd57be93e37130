"""PyTorch / CUDA port of the DIS optical-flow framework for NVIDIA Hopper.

Mirrors the layout of the JAX package (`params`, `ops.pyramid`,
`ops.patch_solver`, `ops.densify`, `ops.tv`, `models.dis`, `cli`,
`pipeline`, `parallel.mesh`, `native.io`, `utils.viz`) and imports nothing
of it. The hot loops run as hand-written CUDA kernels
(`csrc/*.cu`, bound in `kernels/`) on CUDA tensors; CPU tensors take each
kernel's plain PyTorch twin.
"""

from of_dis_tpu_torch.params import DISParams, op_point_params  # noqa: F401
