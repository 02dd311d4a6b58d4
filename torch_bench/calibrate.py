#!/usr/bin/env python3
"""The readings that the check's limits are set from, many seeds in one
process: the program as its configuration states it, or its control (a
lower precision path of the program: a bfloat16 state, or half storage's
bfloat16 deviations), or the program with a fault planted
(``faults.py``). Run from the root of a checkout on the card::

    python3 torch_bench/calibrate.py --workload <cell> --seeds 1,2,3 \
        --seconds 2 [--dtype bfloat16 | --half-storage | --fault half] \
        [--out chiprun_out/readings.jsonl]

Each seed prints one line, the compared numbers and the end-to-end
metrics, and appends it to ``--out`` as JSON.
"""

import argparse
import gc
import json
import os
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
os.environ["TRITON_CACHE_DIR"] = str(ROOT / "build" / "torch_bench" /
                                     "triton")
os.environ["TORCH_EXTENSIONS_DIR"] = str(ROOT / "build" / "torch_bench" /
                                         "torch_extensions")
sys.path.insert(0, str(ROOT))


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--workload", required=True)
    parser.add_argument("--seeds", required=True,
                        help="comma-separated seeds")
    parser.add_argument("--seconds", type=float, default=2.0)
    parser.add_argument("--dtype", default=None)
    parser.add_argument("--half-storage", action="store_true")
    parser.add_argument("--fault", default=None)
    parser.add_argument("--out", default=None)
    args = parser.parse_args(argv)
    from torch_bench import harness
    from torch_bench.faults import FAULTS

    cell = harness.load_cell(args.workload)
    for line in harness.card_lines(cell.chips):
        print(line)
    variant = ("half_storage" if args.half_storage else args.dtype
               or args.fault or "program")
    for seed in (int(s) for s in args.seeds.split(",")):
        beg = time.perf_counter()
        result = harness.run_cell(
            args.workload, seed, args.seconds, False, dtype=args.dtype,
            half_storage=args.half_storage,
            fault=FAULTS[args.fault] if args.fault else None)
        line = {"workload": args.workload, "variant": variant, "seed": seed,
                "correct": result["correct"],
                "checks": {k: c["value"] for k, c in
                           result["checks"].items()},
                "metrics": {k: m["value"] for k, m in
                            result["metrics"].items()},
                "seconds": time.perf_counter() - beg}
        print(json.dumps(line), flush=True)
        del result
        gc.collect()
        harness.torch.cuda.empty_cache()
        if args.out:
            Path(args.out).parent.mkdir(parents=True, exist_ok=True)
            with open(args.out, "a") as fh:
                fh.write(json.dumps(line) + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
