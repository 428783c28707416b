"""The benchmark of the PyTorch and CUDA port (``cholesky_is_magic_tpu_torch``).

``python3 lpbench/run.py --workload <name> --seed <n> --seconds <s> --trace <0|1>``
runs one cell of ``BENCHMARK.json`` once and prints one JSON line.
"""
