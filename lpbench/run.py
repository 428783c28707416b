#!/usr/bin/env python3
"""Run one cell of BENCHMARK.json once, from the root of a checkout:

    python3 lpbench/run.py --workload <name> --seed <n> --seconds <s> --trace <0|1>

It needs a CUDA card (exit 3 without one).  The last line of standard
output is one JSON object: ``correct``, ``attempted``, ``failed``,
``metrics`` (the cell's end-to-end metrics, or with ``--trace 1`` its
per-layer ones), ``device``, with ``--trace 1`` ``breakdown``, and last
``checks``: each number compared with the plain reference beside its limit,
which are also the last lines of standard error.
"""

import os
import sys
import time

T_START = time.perf_counter()
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

# Every build and kernel cache at a fixed place inside the checkout (the
# port's own kernels build into build/cim_torch_kernels/ beside them).
for var, sub in (("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                 ("TRITON_CACHE_DIR", "triton_cache")):
    os.environ[var] = os.path.join(ROOT, "build", sub)
# One process with few threads: the host loop is one Python thread issuing
# kernels, and idle worker threads of the CPU libraries only contend with it.
for var in ("OMP_NUM_THREADS", "MKL_NUM_THREADS", "OPENBLAS_NUM_THREADS"):
    os.environ[var] = "1"
sys.path.insert(0, ROOT)

if __name__ == "__main__":
    from lpbench.harness import main

    sys.exit(main(sys.argv[1:], T_START))
