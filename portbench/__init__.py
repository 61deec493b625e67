"""The benchmark of `dafs_tpu_torch` on one or more NVIDIA cards.

`python portbench/run.py --workload NAME --seed N --seconds S --trace 0|1`
runs one cell of `BENCHMARK.json` (README.md).  Nothing here imports JAX or
the JAX package; `reference/` imports nothing of the port either.
"""
