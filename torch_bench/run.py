#!/usr/bin/env python3
"""The benchmark of lettuce_tpu_torch on one NVIDIA GPU.

Run from the root of a checkout::

    python3 torch_bench/run.py --workload <cell> --seed <n> \
        --seconds <s> --trace <0|1>

The cells are the ``workloads`` of ``BENCHMARK.json``. The last line of
standard output is the result as one JSON object; the numbers the check
compared, each beside its limit, are the last lines of standard error.
Without a CUDA device it exits non-zero and prints no result.
"""

import argparse
import os
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
# every compile cache inside the checkout, at a fixed path; the program's
# own kernels build under build/lettuce_tpu_torch
os.environ["TRITON_CACHE_DIR"] = str(ROOT / "build" / "torch_bench" /
                                     "triton")
os.environ["TORCH_EXTENSIONS_DIR"] = str(ROOT / "build" / "torch_bench" /
                                         "torch_extensions")
sys.path.insert(0, str(ROOT))


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--workload", required=True)
    parser.add_argument("--seed", type=int, required=True)
    parser.add_argument("--seconds", type=float, required=True)
    parser.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = parser.parse_args(argv)
    from torch_bench import harness
    return harness.main(args)


if __name__ == "__main__":
    sys.exit(main())
