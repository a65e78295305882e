"""The benchmark of the PyTorch and CUDA port `grasptrajopt_tpu_torch`.

`BENCHMARK.json` at the root of the repository names the cells; `run.py`
runs one cell once. Configurations sit in `configs/`, traffic mixes in
`traffic/`, one reader a metric in `metrics/`, one driver a kind of
deployment in `drivers/`, and the plain reference in `reference/`. The
limits of `correct`, with the readings they were set from, sit in
`limits/`. Nothing here imports JAX or the JAX package, and the
reference imports nothing of the program.
"""
