"""The benchmark of the PyTorch / CUDA port (`of_dis_tpu_torch`).

One run of one cell: `python -m dis_bench.run --workload <name> --seed <n>
--seconds <s> --trace <0|1>` from the root of a checkout. `run.py` finds
the cell in `BENCHMARK.json`, its configuration in `configs/`, its
traffic mix in `traffic/`, its limits in `limits/`, each per-layer
metric's reader in `metrics/` and each kernel's work count in `work/`,
all by name. Nothing here imports `jax` or the JAX package.
"""
