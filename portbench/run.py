#!/usr/bin/env python3
"""The benchmark of ecrad_tpu_torch on one CUDA card: one run of one cell.

    python3 portbench/run.py --workload <cell> --seed <n> --seconds <s>
        --trace <0|1>

Run from the root of a checkout. Prints each compared number beside its
limit on standard error and one JSON line on standard output; exits with
another code than 0, and prints no result, without the CUDA devices the
cell needs or when a module of JAX or of the JAX package was loaded.
See portbench/harness.py.
"""
import time

T_START = time.perf_counter()

import os  # noqa: E402
import sys  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# every build and kernel cache at a fixed path inside the checkout
for _var, _sub in (("TRITON_CACHE_DIR", "triton"),
                   ("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                   ("CUDA_CACHE_PATH", "nv")):
    os.environ[_var] = os.path.join(ROOT, "portbench", "_cache", _sub)
# one caller: the host's threads stay with the launching thread
for _var in ("OMP_NUM_THREADS", "MKL_NUM_THREADS", "OPENBLAS_NUM_THREADS"):
    os.environ.setdefault(_var, "1")
sys.path.insert(0, ROOT)

from portbench import harness  # noqa: E402

if __name__ == "__main__":
    sys.exit(harness.main(sys.argv[1:], T_START))
