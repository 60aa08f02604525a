"""The benchmark of the PyTorch/CUDA port (`repro_torch`) on NVIDIA H100s.

`python3 perfbench/run.py --workload NAME --seed N --seconds S --trace 0|1`
runs one cell of `BENCHMARK.json` on the card it starts on and prints one
JSON line. Everything is found by name, so a later change adds a cell, a
traffic mix, a configuration or a metric as new files:

* `configs/<config>.json`: a model configuration as it is run, its
  `family` naming the plain reference in `families/<family>.py` (torch
  only) and the port adapter in `families/<family>_port.py`;
* `traffic/<traffic>.json`: a traffic mix, read by `traffic.py`;
* `workloads/<cell>.json`: a cell's serving flags, rate, pool and
  correctness limit;
* `metrics/<metric>.py` (or `.json` naming a reader and its arguments):
  one metric's reader over the run's records (`record.Run`).

The yardstick (traffic, the reduction of records and traces to metrics,
the card's peaks, the operation and byte counts, the plain references and
the comparison that decides `correct`) lives here; from the port the
benchmark takes only the serving engine and its counters. Nothing here
imports `jax` or the JAX package `repro`.
"""
