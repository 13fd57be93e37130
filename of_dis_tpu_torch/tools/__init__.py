"""Measurement and operations tools of the port, each run as
`python -m of_dis_tpu_torch.tools.<name>`: `bench` (pairs/s of the main
path and of the JAX `bench.py`'s other rows, one JSON line), `bench_op`,
`bench_seq`, `bench_stages` (each stage of a call alone),
`bench_tv_parts` (one level's TV refinement in parts),
`profile_pipeline` (device time by kernel), `warmup` (build and warm a
serving process), `eval_epe` (end-point error of output files),
`bench_pipeline` (the serving pipeline's pairs/s at each batch size,
behind `pipeline.DEFAULT_BATCH`), `bench_gn_stages` (T2, the per-stage
ablation of the Gauss-Newton iteration) and `bench_i8_dot` (T1, the
tensor-core dot microbenchmark); `synth` is their synthetic workload."""
