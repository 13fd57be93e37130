"""Measurement tools of the port, each run as
`python -m of_dis_tpu_torch.tools.<name>`: `bench_gn_stages` (T2, the
per-stage ablation of the Gauss-Newton iteration) and `bench_i8_dot` (T1,
the tensor-core dot microbenchmark)."""
